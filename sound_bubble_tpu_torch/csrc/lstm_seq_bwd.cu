// The backward recurrences of the custom-VJP route, one walk for both:
// row 7 (one direction, from (dhT, dcT) down to (dh0, dc0)) and row 9
// (both directions of a BLSTM from zero), in fp32 and in the mixed mode
// (bf16 activations with bf16 or fp32 weights).
//
// Replaces the Pallas TPU kernels of `sound_bubble_tpu/ops/pallas/
// lstm_train_kernel.py`:
// - nd = 1 <- `lstm_seq_bwd` (body `_bwd_kernel`): from the forward's saved
//   post-activation gates [T, R, 4H] ([i | f | g | o]), its cell states
//   c [T, R, H], c0 [R, H] and dy [T, R, H], per step the gate gradients
//   dgates [T, R, 4H] and the carried (dh, dc), entering from (dhT, dcT);
//   writes (dh0, dc0) [R, H] fp32 after the last step.
// - nd = 2 <- the walk of `_bpt_bwd` (body `_blstm_bwd_kernel`): gates
//   [T, R, 8H] gate-major with the direction inside (gate g of direction d
//   at column g*2H + d*H), c [T, R, 2H] (direction d at d*H) and dy
//   [T, R, 2H] (original time; the backward direction's dy is read at the
//   mirrored time); dgates [T, R, 8H] direction-major (d*4H + g*H); each
//   direction's (dh, dc) from zero, c[-1] = 0.
// At step n of the walk (k = T - 1 - n): tc = tanh(c[k]); d = dy + dh;
// dc' = dc + d o (1 - tc^2); di = dc' g i (1 - i), df = dc' c[k - 1] f (1 - f)
// (c[-1] = c0 for nd = 1), dg = dc' i (1 - g^2), do = d tc o (1 - o);
// dc = dc' f, and dh = dgates W_hh^T on the direction's W_hh (nd = 1: w_hh
// [H, 4H]; nd = 2: the pack's diagonal block, w_hh [2H, 8H]
// direction-major, the zero blocks never read). The weight and input
// gradients are products outside, as in the JAX package. The mixed mode
// rounds where the Pallas bodies round: tc = bf16(tanh(bf16(c))), the gate
// gradients rounded to bf16 for the chain and for their store, dh and dc
// carried in fp32. The cell's arithmetic is the plain versions'
// (`lstm_seq_bwd_ref`, `blstm_seq_bwd_ref`), one rounded operation at a
// time (`__fmul_rn` etc., no contraction into FMAs).
//
// What bounds it (H100 SXM, 3.35 TB/s; H = 64): row 9 at the flagship's
// intra BLSTM [145, 1252] fp32 moves ~0.93 GB (gates, c, dy in; dgates
// out), 0.28 ms, against 2*T*R*2*4H*H = 11.9 GFLOP of chain, 0.18 ms at 67
// TFLOP/s: bytes; in the mixed mode at [145, 2504] ~1.0 GB, 0.31 ms. Row 7
// at the inter LSTM [313, 580] fp32 ~0.47 GB, 0.14 ms: bytes. In practice
// the recurrence bounds it: T dependent frames a row tile. A `clock64()`
// split of the first design it replaces (8-row blocks of 512 threads, each
// thread one unit of two rows, W_hh^T in shared memory;
// `tools/split_bwd_cycles.py`) found 68.5 % (row 9) and 59.5 % (row 7) of a
// frame (NVIDIA H100 80GB HBM3 at 700 W, PERF.md §6) in its dh dot, which
// reads one W^T word and two broadcast dg words from shared memory for
// every two FMAs.
//
// Design (`seq_bbwd_kernel<H, XT, WT>`), the counterpart of the forward walk
// of csrc/lstm_fwd32.cuh; the direction count and the ends are runtime
// arguments of the one kernel (a template parameter for the direction count
// doubled this source's 12 instantiations and its compile time, ~35 → ~59
// s on the card's host, for a mixed effect on the rows' times; PERF.md §6):
// - One block of 4H threads a (direction, row tile): blocks [0, tiles) walk
//   the forward direction, with nd = 2 [tiles, 2 tiles) the backward one;
//   rows a block from the wrapper's `seq_bwd_row_tiles`, the fewest that
//   keep the grid within one wave of the card's SMs (row 9: 19 rows at
//   R = 1252 and 38 at R = 2504, 132 blocks; row 7: 5 at R = 580, 116
//   blocks, and 9 at R = 1160, 129). Blocks never wait on each other.
// - The dh chain keeps the direction's W_hh^T in registers, loaded once:
//   lane (up, kq) of warp w holds units 8w + 2up and 8w + 2up + 1 at the
//   gate-gradient columns 4 (8p + kq) .. + 3, p < H / 8 (H fp32 values a
//   lane; bf16 weights widened, exact). Per row a lane reads H / 8
//   4-vectors of the frame's dg tile (the eight lanes kq of a unit pair read
//   128 contiguous bytes, one wavefront a warp) and does 8 FMAs a 4-vector;
//   a reduce-scatter over the eight lanes (7 shuffles for four rows) leaves
//   each lane the dh of one (row, unit) cell, which it applies itself. Its
//   dc lives in a shared-memory slot of its own (the cell never changes
//   lanes); its gate gradients go to the next frame's dg tile (fp32: the
//   bf16-rounded values in the mixed mode, so the chain widens nothing),
//   double-buffered, and to dgates: one __syncthreads a frame. Up to three
//   groups of four rows are one straight-line body, as in the forward walk.
// - With bf16 x and weights (the campaign trainer's pair) the chain runs on
//   the tensor cores instead (`mma_step`: mma.sync m16n8k16, fp32
//   accumulation; bf16 products are exact): warp w owns the units 8w ..
//   8w + 7 as one n-tile, W_hh^T's B fragments in registers (32 a lane at
//   H = 64), the dg tile in bf16 (the chain's values are bf16 in the mixed
//   mode anyway) read as A fragments, rows in 16-row tiles; lane (g, t)
//   applies the cells of rows g, g + 8 and units 2t, 2t + 1 of each tile.
// - The frame's gates, c and dy tiles are copied into shared memory by
//   `cp.async` while the frame before is walked; a c tile serves as c[k] at
//   one step and as c[k - 1] at the one before (three slots; row 7's c0
//   takes the free slot for k = 0). Rows past R are zeros and never
//   written; a four-row group past `rows` computes its padding row on the
//   last real row.
// - Row 7's ends: dcT fills the dc slots before the first frame; the first
//   frame's chain reads a zero tile, and its cells take dhT in its place
//   (mode FIRST); after the last frame one more chain (mode FIN) gives dh0,
//   which the lane that owns each cell stores, and dc0 is the dc slots.
//   Both run outside the frame loop, four rows a group (or one mma tile) at
//   a time, so that the loop's straight-line bodies, row 9's too, hold no
//   test for them.
// Shared memory (`bwd_layout`, the same for either direction count):
// 115,488 B at 19 rows fp32; at 38 rows 149,632 B with bf16 weights and
// 181,120 B with fp32 ones. Everything the kernel reads from device memory
// after its weights goes by `cp.async.cg` (L2 only), so the smaller L1 that
// a block over 164 KB leaves should not slow it (not measured).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "lstm_fwd32.cuh"

namespace sbt_bwd {

using bf16 = __nv_bfloat16;
using sbt_fwd32::bits;
using sbt_fwd32::cp_async16;
using sbt_fwd32::cp_async_commit;
using sbt_fwd32::cp_async_wait_all;
using sbt_fwd32::ld32;
using sbt_fwd32::ldw;
using sbt_fwd32::mma16816;
using sbt_fwd32::put;
using sbt_fwd32::rb;

constexpr int ROWS_MAX = 48;  // rows a block

// The layout of a block's shared memory (byte offsets): the gate tiles
// [2][rows][gs] (x's type; gs = 4H + 8 fp32, 4H + 16 bf16), the c tiles
// [3][rows][H + 8] fp32, the dy tiles [2][rows][H + 8] (x's type), the dg
// tiles [2][rp][4H + 8] (fp32; bf16 for the tensor cores' chain, tc) and
// the dc slots [rp][H + 8] fp32 (rp: rows rounded up to 4; tc: to 16, the
// mma tiles' rows). The row strides keep a warp's cell reads (eight units
// at four rows), its mma fragment loads and the 16-byte `cp.async` pieces
// on distinct banks.
struct BwdLayout {
  size_t c, dy, dg, dc, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int H, int rows, bool mixed,
                                                bool tc) {
  BwdLayout L;
  const size_t rp = (size_t)(rows + (tc ? 15 : 3)) / (tc ? 16 : 4) *
                    (tc ? 16 : 4);
  const size_t eb = mixed ? 2 : 4;
  L.c = (size_t)2 * rows * (4 * H + (mixed ? 16 : 8)) * eb;
  L.dy = L.c + (size_t)12 * rows * (H + 8);
  L.dg = L.dy + 2 * rows * (H + 8) * eb;
  L.dc = L.dg + 2 * rp * (4 * H + 8) * (tc ? 2 : 4);
  L.total = L.dc + (size_t)4 * rp * (H + 8);
  return L;
}

// Shared memory of a block of `rows` rows (bytes), 0 for a shape the kernel
// does not take: H in 8, 16, 32, 64; 1 <= rows <= ROWS_MAX.
inline size_t bwd_smem(int H, int rows, bool mixed, bool tc) {
  if ((H != 8 && H != 16 && H != 32 && H != 64) || rows < 1 ||
      rows > ROWS_MAX)
    return 0;
  return bwd_layout(H, rows, mixed, tc).total;
}

__device__ __forceinline__ float sel(bool c, float a, float b) {
  return c ? a : b;
}
__device__ __forceinline__ float shfl(float v, int m) {
  return __shfl_xor_sync(0xffffffffu, v, m);
}

// Sums over the eight lanes kq of the NR rows' partials of the lane's two
// units (s[r][u]): the lane's (row rho, unit ub); own: the lane that
// applies the cell (NR < 4 leaves the same sums in 4 / NR lanes).
template <int NR>
__device__ __forceinline__ float reduce_rows(const float (*s)[2], int kq,
                                             int& rho, int& ub, bool& own) {
  const bool b0 = kq & 1, b1 = kq & 2, b2 = kq & 4;
  ub = b0;
  if constexpr (NR == 4) {
    float t[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        t[j][u] = sel(b2, s[2 + j][u], s[j][u]) +
                  shfl(sel(b2, s[j][u], s[2 + j][u]), 4);
    float q[2];
#pragma unroll
    for (int u = 0; u < 2; ++u)
      q[u] = sel(b1, t[1][u], t[0][u]) + shfl(sel(b1, t[0][u], t[1][u]), 2);
    rho = 2 * b2 + b1;
    own = true;
    return sel(b0, q[1], q[0]) + shfl(sel(b0, q[0], q[1]), 1);
  } else if constexpr (NR == 2) {
    float t[2];
#pragma unroll
    for (int u = 0; u < 2; ++u)
      t[u] = sel(b2, s[1][u], s[0][u]) + shfl(sel(b2, s[0][u], s[1][u]), 4);
    const float v = sel(b0, t[1], t[0]) + shfl(sel(b0, t[0], t[1]), 1);
    rho = b2;
    own = !b1;
    return v + shfl(v, 2);
  } else {
    float v = sel(b0, s[0][1], s[0][0]) + shfl(sel(b0, s[0][0], s[0][1]), 1);
    v += shfl(v, 2);
    rho = 0;
    own = !b1 && !b2;
    return v + shfl(v, 4);
  }
}

// What a frame reads and writes: its tiles in shared memory (gq gates, cq
// c[k], cpq c[k - 1], at k = 0 c0's tile or null; yq dy; prev the last
// frame's dg tile, cur this frame's, of type TT), the dc slots, and dgates
// from the tile's first row at this step (dgo, at the direction's offset;
// os: its row stride). Row 7's ends, from the tile's first row: dhin dhT
// (mode FIRST), dhout dh0 (mode FIN).
template <typename XT, typename TT>
struct Frame {
  const XT* gq;
  const float* cq;
  const float* cpq;
  const XT* yq;
  const TT* prev;
  TT* cur;
  float* dcs;
  XT* dgo;
  int os;
  const float* dhin;
  float* dhout;
};

// What a frame's cells do: MID the walk's frames; FIRST row 7's first
// frame, whose chain read a zero tile (dh enters as dhT); FIN row 7's chain
// after its last frame, dh0 in place of the cells.
enum { MID, FIRST, FIN };

// The cell of (row, unit m) from its dh: the gate gradients into the dg tile
// and dgates, dc into its slot. Every lane computes (no branch, so the
// compiler can overlap groups); the owner stores.
template <int H, bool M, int MODE, typename XT, typename TT>
__device__ __forceinline__ void cell(float dh, int row, bool own, int m,
                                     int rows, int rt,
                                     const Frame<XT, TT>& f) {
  constexpr int GS = 4 * H + (M ? 16 : 8), CS = H + 8, DS = 4 * H + 8;
  if constexpr (MODE == FIRST) {
    if (row < rt) dh = f.dhin[row * H + m];
  }
  const int sr = min(row, rows - 1);
  const XT* g = f.gq + sr * GS + m;
  const float gi = ldw(g, 0), gf = ldw(g, H), gg = ldw(g, 2 * H),
              go = ldw(g, 3 * H);
  const float ct = f.cq[sr * CS + m];
  const float cp = f.cpq ? f.cpq[sr * CS + m] : 0.f;
  const float dy = ldw(f.yq, sr * CS + m);
  float* dcp = f.dcs + row * CS + m;
  // the plain version's order: tc, d, do, dc' = dc + (d o)(1 - tc^2), ...
  const float tc = M ? rb(tanhf(rb(ct))) : tanhf(ct);
  const float d = __fadd_rn(dy, dh);
  const float dO = __fmul_rn(d, tc);
  const float dC = __fadd_rn(
      *dcp, __fmul_rn(__fmul_rn(d, go), __fsub_rn(1.f, __fmul_rn(tc, tc))));
  const float di =
      __fmul_rn(__fmul_rn(__fmul_rn(dC, gg), gi), __fsub_rn(1.f, gi));
  const float df =
      __fmul_rn(__fmul_rn(__fmul_rn(dC, cp), gf), __fsub_rn(1.f, gf));
  const float dg =
      __fmul_rn(__fmul_rn(dC, gi), __fsub_rn(1.f, __fmul_rn(gg, gg)));
  const float dO2 = __fmul_rn(__fmul_rn(dO, go), __fsub_rn(1.f, go));
  if (own) {
    *dcp = __fmul_rn(dC, gf);
    // the chain takes the gate gradients in bf16 in the mixed mode
    TT* o = f.cur + row * DS + m;
    put(o, 0, M ? rb(di) : di);
    put(o, H, M ? rb(df) : df);
    put(o, 2 * H, M ? rb(dg) : dg);
    put(o, 3 * H, M ? rb(dO2) : dO2);
  }
  if (own && row < rt) {
    XT* o = f.dgo + (size_t)row * f.os + m;
    put(o, 0, di); put(o, H, df); put(o, 2 * H, dg); put(o, 3 * H, dO2);
  }
}

// Row 7's dh0 of (row, unit m), after its last frame: stored by the lane
// that owns the cell.
template <int H, typename XT, typename TT>
__device__ __forceinline__ void put_dh0(float dh, int row, bool own, int m,
                                        int rt, const Frame<XT, TT>& f) {
  if (own && row < rt) f.dhout[row * H + m] = dh;
}

// One frame's cells of up to three row groups from row g: NA, NB, NC rows
// (4, 2 or 1; 0: no group): dh for all of them, then each group's reduce
// and cells (MODE), as one straight-line body.
template <int H, bool M, typename XT, int NA, int NB, int NC,
          int MODE = MID>
__device__ __forceinline__ void rows_step(int g, const float4 (&wr)[H / 8][2],
                                          int kq, int m0, int rows, int rt,
                                          const Frame<XT, float>& f) {
  constexpr int N = NA + NB + NC, DS = 4 * H + 8;
  float s[N][2];
#pragma unroll
  for (int r = 0; r < N; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll
  for (int p = 0; p < H / 8; ++p) {
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(
          f.prev + (g + r) * DS + 4 * (8 * p + kq));
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        s[r][u] = fmaf(v.x, wr[p][u].x, s[r][u]);
        s[r][u] = fmaf(v.y, wr[p][u].y, s[r][u]);
        s[r][u] = fmaf(v.z, wr[p][u].z, s[r][u]);
        s[r][u] = fmaf(v.w, wr[p][u].w, s[r][u]);
      }
    }
  }
  int rho[3] = {0, 0, 0}, ub[3] = {0, 0, 0};
  bool own[3] = {false, false, false};
  float v[3];
  v[0] = reduce_rows<NA>(s, kq, rho[0], ub[0], own[0]);
  if constexpr (NB > 0)
    v[1] = reduce_rows<NB>(s + NA, kq, rho[1], ub[1], own[1]);
  if constexpr (NC > 0)
    v[2] = reduce_rows<NC>(s + NA + NB, kq, rho[2], ub[2], own[2]);
  if constexpr (MODE == FIN) {
    static_assert(NB == 0 && NC == 0, "one group at a time");
    put_dh0<H>(v[0], g + rho[0], own[0], m0 + ub[0], rt, f);
  } else {
    cell<H, M, MODE>(v[0], g + rho[0], own[0], m0 + ub[0], rows, rt, f);
    if constexpr (NB > 0)
      cell<H, M, MODE>(v[1], g + NA + rho[1], own[1], m0 + ub[1], rows, rt,
                       f);
    if constexpr (NC > 0)
      cell<H, M, MODE>(v[2], g + NA + NB + rho[2], own[2], m0 + ub[2],
                       rows, rt, f);
  }
}

// The tensor cores' chain (bf16 x and weights): one frame's cells of NMT
// 16-row tiles from row 16 mt0. Warp w owns the units 8w .. 8w + 7 (an
// n-tile; W_hh^T's B fragments in registers, bfr) and walks the k-steps of
// 16 gate-gradient columns, each tile's A fragment from the bf16 dg tile
// (exact: the chain's values are bf16), an accumulator chain a tile; lane
// (g, t) then holds dh of rows g and g + 8, units 2t and 2t + 1, and applies
// those four cells (MODE as rows_step's).
template <int H, typename XT, int NMT, int MODE = MID>
__device__ __forceinline__ void mma_step(int mt0,
                                         const unsigned (&bfr)[H / 4][2],
                                         int u0, int rows, int rt,
                                         const Frame<XT, bf16>& f) {
  constexpr int DS = 4 * H + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float d[NMT][4];
#pragma unroll
  for (int m = 0; m < NMT; ++m) d[m][0] = d[m][1] = d[m][2] = d[m][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < H / 4; ++ks) {
#pragma unroll
    for (int m = 0; m < NMT; ++m) {
      const bf16* a0 = f.prev + (16 * (mt0 + m) + g) * DS + 16 * ks + 2 * t;
      const unsigned a[4] = {ld32(a0), ld32(a0 + 8 * DS), ld32(a0 + 8),
                             ld32(a0 + 8 * DS + 8)};
      mma16816(d[m], a, bfr[ks]);
    }
  }
#pragma unroll
  for (int m = 0; m < NMT; ++m) {
    const int r = 16 * (mt0 + m) + g, u = u0 + 2 * t;
    if constexpr (MODE == FIN) {
      put_dh0<H>(d[m][0], r, true, u, rt, f);
      put_dh0<H>(d[m][1], r, true, u + 1, rt, f);
      put_dh0<H>(d[m][2], r + 8, true, u, rt, f);
      put_dh0<H>(d[m][3], r + 8, true, u + 1, rt, f);
    } else {
      cell<H, true, MODE>(d[m][0], r, true, u, rows, rt, f);
      cell<H, true, MODE>(d[m][1], r, true, u + 1, rows, rt, f);
      cell<H, true, MODE>(d[m][2], r + 8, true, u, rows, rt, f);
      cell<H, true, MODE>(d[m][3], r + 8, true, u + 1, rows, rt, f);
    }
  }
}

// Block (d, tile): the walk of direction d of nd over the tile's rows. XT:
// x's type (dy, dgates and the saved gates: bf16 in the mixed mode), WT:
// the weights'. Row 7 (nd = 1) passes its ends c0, dhT, dcT, dh0 and dc0;
// row 9 (nd = 2) passes null for all five.
template <int H, typename XT, typename WT>
__global__ void __launch_bounds__(4 * H, 1) seq_bbwd_kernel(
    const XT* __restrict__ gates, const float* __restrict__ cseq,
    const XT* __restrict__ dy, const WT* __restrict__ w_hh,
    XT* __restrict__ dgates, const float* __restrict__ c0,
    const float* __restrict__ dhT, const float* __restrict__ dcT,
    float* __restrict__ dh0, float* __restrict__ dc0, int T, int R, int nd,
    int rows) {
  constexpr bool M =
      std::is_same<XT, bf16>::value || std::is_same<WT, bf16>::value;
  static_assert(M == std::is_same<XT, bf16>::value,
                "the mixed mode takes bf16 x");
  // bf16 x and weights: the chain on the tensor cores, its dg tile in bf16
  constexpr bool TC = std::is_same<WT, bf16>::value;
  using TT = typename std::conditional<TC, bf16, float>::type;
  constexpr int NT = 4 * H, DS = 4 * H + 8, CS = H + 8;
  constexpr int GS = 4 * H + (M ? 16 : 8);
  constexpr int EPV = 16 / sizeof(XT);  // elements a 16-byte piece
  constexpr int GV = H / EPV, CV = H / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdLayout L = bwd_layout(H, rows, M, TC);
  XT* gts = reinterpret_cast<XT*>(smem);                 // [2][rows][GS]
  float* cts = reinterpret_cast<float*>(smem + L.c);     // [3][rows][CS]
  XT* dys = reinterpret_cast<XT*>(smem + L.dy);          // [2][rows][CS]
  TT* dgt = reinterpret_cast<TT*>(smem + L.dg);          // [2][rp][DS]
  float* dcs = reinterpret_cast<float*>(smem + L.dc);    // [rp][CS]
  const int tiles = (R + rows - 1) / rows;
  const int d = blockIdx.x >= tiles, tile = blockIdx.x - d * tiles;
  const int tid = threadIdx.x, NH = nd * H;
  const int rp = TC ? (rows + 15) / 16 * 16 : (rows + 3) / 4 * 4;
  const int row0 = tile * rows, rt = min(rows, R - row0);

  // the tile's rows of c[kc] (src: its first row, row stride NH) into
  // slot s
  auto load_c = [&](int s, const float* src) {
    float* dst = cts + s * rows * CS;
    for (int i = tid; i < rt * CV; i += NT) {
      const int r = i / CV, v = i - r * CV;
      cp_async16(dst + r * CS + 4 * v, src + (size_t)r * NH + 4 * v);
    }
  };
  // step n's gates and dy (slot n & 1) and c[k - 1] (k = T - 1 - n)
  auto load = [&](int n) {
    const int k = T - 1 - n, t_dy = d ? n : k;
    XT* gd = gts + (n & 1) * rows * GS;
    const XT* gs = gates + ((size_t)k * R + row0) * 4 * NH + d * H;
    for (int i = tid; i < rt * 4 * GV; i += NT) {
      const int r = i / (4 * GV), rem = i - r * 4 * GV;
      const int gt = rem / GV, v = rem - gt * GV;
      cp_async16(gd + r * GS + gt * H + EPV * v,
                 gs + (size_t)r * 4 * NH + gt * NH + EPV * v);
    }
    XT* yd = dys + (n & 1) * rows * CS;
    const XT* ys = dy + ((size_t)t_dy * R + row0) * NH + d * H;
    for (int i = tid; i < rt * GV; i += NT) {
      const int r = i / GV, v = i - r * GV;
      cp_async16(yd + r * CS + EPV * v, ys + (size_t)r * NH + EPV * v);
    }
    if (k > 0)
      load_c((k - 1) % 3, cseq + ((size_t)(k - 1) * R + row0) * NH + d * H);
    else if (c0)  // row 7: c[-1] = c0, in the slot that c[2] left
      load_c(2, c0 + (size_t)row0 * H);
    cp_async_commit();
  };
  load_c((T - 1) % 3, cseq + ((size_t)(T - 1) * R + row0) * NH + d * H);
  load(0);

  // zeros: the tiles' rows past R (never copied), the dg tiles (the first
  // frame's chain reads one) and the dc slots
  for (int i = tid; i < (rows - rt) * GS; i += NT) {
    const int r = rt + i / GS, e = i - (i / GS) * GS;
    put(gts, r * GS + e, 0.f);
    put(gts, (rows + r) * GS + e, 0.f);
  }
  for (int i = tid; i < (rows - rt) * CS; i += NT) {
    const int r = rt + i / CS, e = i - (i / CS) * CS;
    for (int j = 0; j < 3; ++j) cts[(j * rows + r) * CS + e] = 0.f;
    put(dys, r * CS + e, 0.f);
    put(dys, (rows + r) * CS + e, 0.f);
  }
  for (int i = tid; i < 2 * rp * DS; i += NT) put(dgt, i, 0.f);
  for (int i = tid; i < rp * CS; i += NT) {  // dc: dcT (row 7) or zeros
    const int r = i / CS, e = i - r * CS;
    dcs[i] = dcT && r < rt && e < H ? dcT[(size_t)(row0 + r) * H + e] : 0.f;
  }

  // step n's frame: its tiles, the dg tile it reads and the one it writes;
  // n = T (row 7): the last frame's dg tile, read by the chain for dh0
  auto frame = [&](int n) {
    const int k = max(T - 1 - n, 0);
    const float* cp = n < T - 1 ? cts + ((k - 1) % 3) * rows * CS
                                : (c0 ? cts + 2 * rows * CS : nullptr);
    return Frame<XT, TT>{gts + (n & 1) * rows * GS,
                         cts + (k % 3) * rows * CS,
                         cp,
                         dys + (n & 1) * rows * CS,
                         dgt + ((n & 1) ^ 1) * rp * DS,
                         dgt + (n & 1) * rp * DS,
                         dcs,
                         dgates + ((size_t)k * R + row0) * 4 * NH + d * 4 * H,
                         4 * NH,
                         dhT ? dhT + (size_t)row0 * H : nullptr,
                         dh0 ? dh0 + (size_t)row0 * H : nullptr};
  };
  // row 7's first frame (the loop's frames start after it)
  const int n0 = dhT ? 1 : 0;
  const int lane = tid & 31, warp = tid >> 5;
  if constexpr (TC) {
    // lane (g, t) of warp w: W_hh^T's B fragments of the units 8w .. 8w + 7
    // (column g) at the k-steps' rows 2t, 2t + 1 and 2t + 8, 2t + 9
    const int g = lane >> 2, t = lane & 3;
    unsigned bfr[H / 4][2];
#pragma unroll
    for (int ks = 0; ks < H / 4; ++ks) {
      const size_t o = (size_t)(d * H + 8 * warp + g) * 4 * NH +
                       d * 4 * H + 16 * ks + 2 * t;
      bfr[ks][0] = bits(w_hh, o) | bits(w_hh, o + 1) << 16;
      bfr[ks][1] = bits(w_hh, o + 8) | bits(w_hh, o + 9) << 16;
    }
    cp_async_wait_all();
    __syncthreads();
    if (n0) {  // row 7's first frame, a tile at a time
      if (1 < T) load(1);
      for (int mt = 0; mt < rp / 16; ++mt)
        mma_step<H, XT, 1, FIRST>(mt, bfr, 8 * warp, rows, rt, frame(0));
      cp_async_wait_all();
      __syncthreads();
    }
    for (int n = n0; n < T; ++n) {
      if (n + 1 < T) load(n + 1);
      const Frame<XT, TT> f = frame(n);
      switch (rp / 16) {
        case 1: mma_step<H, XT, 1>(0, bfr, 8 * warp, rows, rt, f); break;
        case 2: mma_step<H, XT, 2>(0, bfr, 8 * warp, rows, rt, f); break;
        default: mma_step<H, XT, 3>(0, bfr, 8 * warp, rows, rt, f);
      }
      cp_async_wait_all();
      __syncthreads();  // the next frame's tiles are in; this dg tile is done
    }
    if (dh0)  // row 7: dh0 from the last frame's dg tile, a tile at a time
      for (int mt = 0; mt < rp / 16; ++mt)
        mma_step<H, XT, 1, FIN>(mt, bfr, 8 * warp, rows, rt, frame(T));
  } else {
    // the FMA chain's lane (up, kq) of warp w: units m0, m0 + 1
    // (m0 = 8w + 2up), gate-gradient columns 4 (8p + kq) .. + 3
    const int kq = lane & 7, m0 = 8 * warp + 2 * (lane >> 3);
    float4 wr[H / 8][2];
#pragma unroll
    for (int p = 0; p < H / 8; ++p)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const size_t o =
            (size_t)(d * H + m0 + u) * 4 * NH + d * 4 * H + 4 * (8 * p + kq);
        wr[p][u] = make_float4(ldw(w_hh, o), ldw(w_hh, o + 1),
                               ldw(w_hh, o + 2), ldw(w_hh, o + 3));
      }
    cp_async_wait_all();
    __syncthreads();
    if (n0) {  // row 7's first frame, 4 rows at a time
      if (1 < T) load(1);
      for (int g = 0; g < rows; g += 4)
        rows_step<H, M, XT, 4, 0, 0, FIRST>(g, wr, kq, m0, rows, rt,
                                            frame(0));
      cp_async_wait_all();
      __syncthreads();
    }
    for (int n = n0; n < T; ++n) {
      if (n + 1 < T) load(n + 1);
      const Frame<XT, TT> f = frame(n);
      int g = 0;
      for (; rows - g > 12; g += 12)
        rows_step<H, M, XT, 4, 4, 4>(g, wr, kq, m0, rows, rt, f);
#define SBT_ROWS(A, B, C_)                                    \
  rows_step<H, M, XT, A, B, C_>(g, wr, kq, m0, rows, rt, f);  \
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
      cp_async_wait_all();
      __syncthreads();  // the next frame's tiles are in; this dg tile is done
    }
    if (dh0)  // row 7: dh0 from the last frame's dg tile, 4 rows at a time
      for (int g = 0; g < rows; g += 4)
        rows_step<H, M, XT, 4, 0, 0, FIN>(g, wr, kq, m0, rows, rt,
                                          frame(T));
  }
  if (dc0)  // row 7: dc after the last frame
    for (int i = tid; i < rt * H; i += NT) {
      const int r = i / H, m = i - r * H;
      dc0[(size_t)(row0 + r) * H + m] = dcs[r * CS + m];
    }
}

template <typename XT, typename WT>
int bbwd(const void* gates, const float* cseq, const void* dy,
         const void* w_hh, void* dgates, const float* c0, const float* dhT,
         const float* dcT, float* dh0, float* dc0, int T, int R, int H,
         int nd, int rows, cudaStream_t st) {
  static void (*const ks[4])(const XT*, const float*, const XT*, const WT*,
                             XT*, const float*, const float*, const float*,
                             float*, float*, int, int, int, int) = {
      seq_bbwd_kernel<8, XT, WT>, seq_bbwd_kernel<16, XT, WT>,
      seq_bbwd_kernel<32, XT, WT>, seq_bbwd_kernel<64, XT, WT>};
  return sbt_fwd32::launch_smem(
      ks,
      bwd_smem(H, rows, !std::is_same<XT, float>::value,
               std::is_same<WT, bf16>::value),
      H, T, R, rows, nd, st, (const XT*)gates, cseq, (const XT*)dy,
      (const WT*)w_hh, (XT*)dgates, c0, dhT, dcT, dh0, dc0, T, R, nd, rows);
}

int bwd_dtypes(int dtypes, const void* gates, const float* cseq,
               const void* dy, const void* w_hh, void* dgates,
               const float* c0, const float* dhT, const float* dcT,
               float* dh0, float* dc0, int T, int R, int H, int nd, int rows,
               cudaStream_t st) {
  switch (dtypes) {
    case 0:
      return bbwd<float, float>(gates, cseq, dy, w_hh, dgates, c0, dhT, dcT,
                                dh0, dc0, T, R, H, nd, rows, st);
    case 1:
      return bbwd<bf16, bf16>(gates, cseq, dy, w_hh, dgates, c0, dhT, dcT,
                              dh0, dc0, T, R, H, nd, rows, st);
    case 2:
      return bbwd<bf16, float>(gates, cseq, dy, w_hh, dgates, c0, dhT, dcT,
                               dh0, dc0, T, R, H, nd, rows, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sbt_bwd

// dtypes: the (x, weights) pair, 0 = (fp32, fp32), 1 = (bf16, bf16),
// 2 = (bf16, fp32) (`DTYPES` in ops/kernels/lstm_slab.py): gates, dy and
// dgates in x's type, c and the ends fp32, w_hh in the weights'. rows:
// rows a block; the block's shared memory is `sbt_blstm_seq_bwd_smem`'s for
// either entry (0 for a shape the kernel does not take: H in 8, 16, 32, 64,
// 1 <= rows <= 48). Each returns 0 or a CUDA error code.

extern "C" size_t sbt_blstm_seq_bwd_smem(int H, int rows, int dtypes) {
  return sbt_bwd::bwd_smem(H, rows, dtypes != 0, dtypes == 1);
}

// Row 9: w_hh the [2H, 8H] pack; 2 x ceil(R / rows) blocks of 4H threads.
extern "C" int sbt_blstm_seq_bwd(const void* gates, const float* cseq,
                                 const void* dy, const void* w_hh,
                                 void* dgates, int T, int R, int H,
                                 int dtypes, int rows, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  return sbt_bwd::bwd_dtypes(dtypes, gates, cseq, dy, w_hh, dgates, nullptr,
                             nullptr, nullptr, nullptr, nullptr, T, R, H, 2,
                             rows, (cudaStream_t)stream);
}

// Row 7: w_hh [H, 4H]; c0, dhT, dcT in and dh0, dc0 out, [R, H] fp32 (c0
// 16-byte aligned: it is copied in 16-byte pieces); ceil(R / rows) blocks
// of 4H threads.
extern "C" int sbt_lstm_seq_bwd(const void* gates, const float* cseq,
                                const float* c0, const void* dy,
                                const void* w_hh, const float* dhT,
                                const float* dcT, void* dgates, float* dh0,
                                float* dc0, int T, int R, int H, int dtypes,
                                int rows, void* stream) {
  cudaGetLastError();
  if (!c0 || !dhT || !dcT || !dh0 || !dc0) return (int)cudaErrorInvalidValue;
  return sbt_bwd::bwd_dtypes(dtypes, gates, cseq, dy, w_hh, dgates, c0, dhT,
                             dcT, dh0, dc0, T, R, H, 1, rows,
                             (cudaStream_t)stream);
}
