"""Run the LSTM forward walk (`sound_bubble_tpu_torch/csrc/
lstm_fwd32.cuh`) on the CPU, in all of its kernels, against the plain
versions: a check of the kernels' logic where there is no card and no nvcc.

    python tools/emulate_fwd_walk.py [--out DIR]
        [--only infer,bseq,seq,slab,mixed,stack]

Copies the header and the kernels that include it (row 5's
`csrc/lstm_infer.cu`; rows 6a, 8a and 8b from `csrc/lstm_seq.cu`, row 10
from `csrc/lstm_slab.cu`, cut out between their section comments; row 6b's
`csrc/lstm_seq_fwd_mixed.cu`) into DIR
(default `_archive/emulate_fwd_walk`, listed in .gitignore), rewritten for
the host: `rcp.approx` becomes a division, the `cp.async` helpers a
`memcpy` and nothing, a launch a call of `emu::launch`. A header in place of
`cuda_runtime.h` runs each block with one `std::thread` a CUDA thread,
blocks one after another: `__syncthreads` is a `std::barrier`,
`__shfl_xor_sync` an exchange through a buffer a warp, and the dynamic
shared memory a namespace-scope array of 232,448 bytes, filled with NaN
before each block. g++ builds it into a library that `ctypes` calls on CPU
tensors, at rows a block 1-19, ragged R, T = 1 and C = 32, 24, 16 (and
C = H = 8): every output within 1e-5 of `blstm_infer_ref`,
`blstm_seq_fwd_ref`, `lstm_seq_fwd_ref` and `lstm_slab_fwd_ref`. Prints a
line a case and the worst error a kernel; exits non-zero past 1e-5.
About two minutes on 8 cores.

`--only mixed` runs the walk's mixed mode (rows 10b, 8b and 6b: bf16 x,
bf16 or fp32 weights) the same way, with a bf16 type that rounds to nearest
even by bit operations in place of `cuda_bf16.h` and `mma.sync` m16n8k16
done from the fragments of all 32 lanes (A rows g / g + 8, columns 2t,
2t + 8; B rows 2t, 2t + 8, column g; D rows g / g + 8, columns 2t,
2t + 1), against `lstm_slab_fwd_ref`, `blstm_seq_fwd_ref` and
`lstm_seq_fwd_ref` under the card's bars (chip_smoke.py phases 13 and 20):
every output within 1e-2 of its peak; the slab's ys within one bf16 ulp of
its peak everywhere, the seq forwards' bf16 outputs bit-equal at all but
5 % of their elements; at rows a block 1, 9 and 19 (and 38, row 8b's
one-wave tile), ragged R and T, both directions, C = 32, 24, 16 (and
C = H = 8).

`--only bwd` runs the backward walk (`csrc/lstm_seq_bwd.cu`) the same way,
in both of its direction counts: row 9 against `blstm_seq_bwd_ref` on the
plain forward's gates and c, row 7 against `lstm_seq_bwd_ref` (drawn c0,
dhT, dcT; dgates, dh0 and dc0), in fp32 (within 1e-4 of the peak) and both
mixed pairs (the mixed bars), at rows a block 1, 19 and 38, tails of 1-3
rows, ragged R, T = 1 and H = 8, 16, 32, 64 (`BWD_CASES`). `--only
seqtest` runs rows 6b, 7 and 9 at the exact draws of
tests/test_torch_port_cuda.py's `test_seq_kernels_match_plain` (every shape
and pair, rows a block as the wrappers pick them on 132 SMs) under the
card's bars. These and `--only mixed` take ~1-14 minutes; the
test's `wide` shape (R = 2504) takes most of `seqtest`'s. With fp32
weights a bf16 x times fp32 w product is inexact, so the plain version's
bf16 roundings follow its fp32 matmul's summation order, which is MKL's
here and cuBLAS's on the card: row 6b with fp32 weights fails `c24` (y
1.26e-02 of its peak) and `wide` (gates 1.57e-02) here, while on the card
only `c24` fails (at the same 1.26e-02; `tools/mixed_order_sensitivity.py
--device cuda`).

`--only stack` runs the stack steps' cluster kernel (rows 1-4,
`csrc/stack_walk.cu`, which includes the walk) the same way, all eight
blocks of the cluster at once (a cluster barrier is a `std::barrier` over
their threads, each block with shared memory of its own), through its C
entry points against `gridnet_stack_step_ref` / `_attn_ref`: the plain and
the conv_lstm intra, with and without attention, at small and at the edge
and flagship widths (`STACK_CASES`).
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
SMEM = 232448

HOST_CUDA = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <math.h>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __shared__
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
struct alignas(8) uint2 { unsigned x, y; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float2 make_float2(float a, float b) { return {a, b}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __frcp_rn(float d) { return 1.0f / d; }
struct uint3e { unsigned x, y, z; };
inline thread_local uint3e threadIdx, blockIdx, blockDim;
using std::max;
using std::min;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <typename T>
inline int cudaFuncSetAttribute(T, cudaFuncAttribute, int) {
  return 0;
}
inline int cudaGetLastError() { return 0; }
template <typename T> inline T __ldg(const T* p) { return *p; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
template <typename T> inline T __ldcg(const T* p) { return *p; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};

namespace emu {
struct Warp {
  std::barrier<>* bar;
  float buf[32];
  unsigned fa[32][4], fb[32][2];  // mma fragments of the 32 lanes
};
inline thread_local std::barrier<>* block_bar;
inline thread_local std::barrier<>* cluster_bar;
inline thread_local Warp* warp;
inline thread_local int lane;
inline thread_local unsigned char* cta_smem;  // the block's shared memory
extern unsigned char* smem_base;
extern size_t smem_cap;

template <typename K, typename... A>
void launch(K k, unsigned grid, unsigned nt, size_t smem, A... args) {
  if (smem > smem_cap) throw 1;
  for (unsigned b = 0; b < grid; ++b) {
    std::memset(smem_base, 0xff, smem_cap);  // NaN in every float
    std::barrier<> bar(nt);
    std::vector<Warp> warps(nt / 32);
    for (auto& w : warps) w.bar = new std::barrier<>(32);
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < nt; ++t)
      ts.emplace_back([&, t] {
        threadIdx = {t, 0, 0};
        blockIdx = {b, 0, 0};
        blockDim = {nt, 1, 1};
        block_bar = &bar;
        cta_smem = smem_base;
        warp = &warps[t / 32];
        lane = t % 32;
        k(args...);
      });
    for (auto& th : ts) th.join();
    for (auto& w : warps) delete w.bar;
  }
}

// One cluster of `grid` blocks at once (a std::thread a CUDA thread of
// every block), each block with shared memory of its own filled with NaN;
// a cluster barrier is a std::barrier over all of them.
template <typename K, typename... A>
void launch_cluster(K k, unsigned grid, unsigned nt, size_t smem,
                    A... args) {
  if (smem > smem_cap) throw 1;
  std::vector<std::vector<unsigned char>> mem(
      grid, std::vector<unsigned char>(smem + 16, 0xff));
  std::barrier<> cbar(grid * nt);
  std::vector<std::barrier<>*> bars;
  std::vector<std::vector<Warp>> warps(grid, std::vector<Warp>(nt / 32));
  for (unsigned b = 0; b < grid; ++b) {
    bars.push_back(new std::barrier<>(nt));
    for (auto& w : warps[b]) w.bar = new std::barrier<>(32);
  }
  std::vector<std::thread> ts;
  for (unsigned b = 0; b < grid; ++b)
    for (unsigned t = 0; t < nt; ++t)
      ts.emplace_back([&, b, t] {
        threadIdx = {t, 0, 0};
        blockIdx = {b, 0, 0};
        blockDim = {nt, 1, 1};
        block_bar = bars[b];
        cluster_bar = &cbar;
        warp = &warps[b][t / 32];
        lane = t % 32;
        cta_smem = reinterpret_cast<unsigned char*>(
            (reinterpret_cast<size_t>(mem[b].data()) + 15) / 16 * 16);
        k(args...);
      });
  for (auto& th : ts) th.join();
  for (unsigned b = 0; b < grid; ++b) {
    delete bars[b];
    for (auto& w : warps[b]) delete w.bar;
  }
}
}  // namespace emu

template <typename... P, typename... A>
int cudaLaunchKernelEx(const cudaLaunchConfig_t* c, void (*k)(P...),
                       A&&... args) {
  emu::launch_cluster(k, c->gridDim.x, c->blockDim.x, c->dynamicSmemBytes,
                      args...);
  return 0;
}
inline int cudaOccupancyMaxActiveClusters(int* n, const void*,
                                          const cudaLaunchConfig_t*) {
  *n = 1;
  return 0;
}

inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int m) {
  emu::warp->buf[emu::lane] = v;
  emu::warp->bar->arrive_and_wait();
  const float r = emu::warp->buf[emu::lane ^ m];
  emu::warp->bar->arrive_and_wait();
  return r;
}
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, D = A B + D, from the
// fragments of all 32 lanes (a bf16 pair in a register: the lower column
// or row in its low half)
inline void emu_mma(float (&d)[4], const unsigned (&a)[4],
                    const unsigned (&b)[2]) {
  emu::Warp* w = emu::warp;
  const int l = emu::lane;
  for (int i = 0; i < 4; ++i) w->fa[l][i] = a[i];
  w->fb[l][0] = b[0];
  w->fb[l][1] = b[1];
  w->bar->arrive_and_wait();
  auto half = [](unsigned v, int k) {
    return __uint_as_float((k & 1 ? v >> 16 : v & 0xffffu) << 16);
  };
  auto A = [&](int row, int k) {
    return half(w->fa[(row & 7) * 4 + ((k & 7) >> 1)][(row >> 3) +
                                                       2 * (k >> 3)], k);
  };
  auto B = [&](int k, int col) {
    return half(w->fb[col * 4 + ((k & 7) >> 1)][k >> 3], k);
  };
  const int g = l >> 2, t = l & 3;
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * t + (i & 1);
    float s = d[i];
    for (int k = 0; k < 16; ++k) s += A(row, k) * B(k, col);
    out[i] = s;
  }
  w->bar->arrive_and_wait();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}
"""

# cuda_bf16.h for the host: bf16 as its 16 bits, rounded to nearest even
HOST_BF16 = r"""
#pragma once
#include <cstring>
#include <cuda_runtime.h>
struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u)   // NaN stays NaN
    return {(unsigned short)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(unsigned short)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
  const unsigned u = (unsigned)b.x << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
inline float2 __bfloat1622float2(__nv_bfloat162 v) {
  return {__bfloat162float(v.x), __bfloat162float(v.y)};
}
"""

STORAGE = r"""
namespace emu {
alignas(16) unsigned char smem_storage[%(smem)d];
unsigned char* smem_base = smem_storage;
size_t smem_cap = %(smem)d;
}
"""

ENTRIES = STORAGE + r"""
extern "C" int emu_seq_fwd(const void* x, const void* w_ih_f,
                           const void* w_ih_b, const void* w_hh,
                           const void* b, const float* h0, const float* c0,
                           void* y, void* gates, float* cseq, int T, int R,
                           int C, int H, int nd, int rows) {
  if (nd == 1)
    return seq_fwd32(x, w_ih_f, w_hh, b, h0, c0, y, gates, cseq, T, R, C, H,
                     rows, nullptr);
  return seq_bfwd32(x, w_ih_f, w_ih_b, w_hh, b, y, gates, cseq, T, R, C, H,
                    rows, nullptr);
}
extern "C" int emu_slab_fwd(const void* x, const void* w_ih,
                            const void* w_hh, const void* b, const float* h0,
                            const float* c0, void* ys, float* hT, float* cT,
                            float* c_ckpt, int T, int R, int C, int H,
                            int kf, int reverse, int rows, int dtypes) {
  if (dtypes == 1)
    return slab_fwd_mixed<bf16>(x, w_ih, w_hh, b, h0, c0, ys, hT, cT,
                                c_ckpt, T, R, C, H, kf, reverse, rows,
                                nullptr);
  if (dtypes == 2)
    return slab_fwd_mixed<float>(x, w_ih, w_hh, b, h0, c0, ys, hT, cT,
                                 c_ckpt, T, R, C, H, kf, reverse, rows,
                                 nullptr);
  return slab_fwd32(x, w_ih, w_hh, b, h0, c0, ys, hT, cT, c_ckpt, T, R, C, H,
                    kf, reverse, rows, nullptr);
}
extern "C" int emu_seq_fwd_mixed(const void* x, const void* w_ih,
                                 const void* w_hh, const void* b,
                                 const float* h0, const float* c0, void* y,
                                 void* gates, float* cseq, int T, int R,
                                 int C, int H, int rows, int dtypes) {
  return sbt_seq_fwd_mixed(dtypes, x, w_ih, w_hh, b, h0, c0, y, gates,
                           cseq, T, R, C, H, rows, nullptr);
}
extern "C" int emu_bseq_fwd_mixed(const void* x, const void* w_ih_f,
                                  const void* w_ih_b, const void* w_hh,
                                  const void* b, void* y, void* gates,
                                  float* cseq, int T, int R, int C, int H,
                                  int rows, int dtypes) {
  if (dtypes == 1)
    return seq_bfwd_mixed<bf16>(x, w_ih_f, w_ih_b, w_hh, b, y, gates, cseq,
                                T, R, C, H, rows, nullptr);
  return seq_bfwd_mixed<float>(x, w_ih_f, w_ih_b, w_hh, b, y, gates, cseq,
                               T, R, C, H, rows, nullptr);
}
"""


def cut(text, start, end):
    i = text.index(start)
    return text[i:text.index(end, i)]


def once(text, old, new):
    if text.count(old) != 1:
        raise RuntimeError(f"{old[:60]!r} found {text.count(old)} times")
    return text.replace(old, new)


SHARED = "extern __shared__ __align__(16) unsigned char smem[];"
HOST_SHARED = "unsigned char* const smem = emu::cta_smem;"


def read(name):
    with open(os.path.join(REPO, "sound_bubble_tpu_torch", "csrc",
                           name)) as fh:
        return fh.read()


def build(out):
    """The host copy of the walk's kernels in out, built; the library."""
    walk = once(read("lstm_fwd32.cuh"),
                'asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));',
                "r = 1.0f / d;")
    walk = once(walk, SHARED, HOST_SHARED)
    for fn, body in (("cp_async16(void* dst, const void* src)",
                      " std::memcpy(dst, src, 16); "),
                     ("cp_async_commit()", ""), ("cp_async_wait_all()", "")):
        walk, n = re.subn(r"(void " + re.escape(fn) + r" \{).*?\n\}",
                          r"\g<1>" + body + "}", walk, flags=re.S)
        if n != 1:
            raise RuntimeError(f"lstm_fwd32.cuh: {fn} not found")
    walk, n = re.subn(r"(void mma16816\(float \(&d\)\[4\], const unsigned "
                      r"\(&a\)\[4\],\s+const unsigned \(&b\)\[2\]\) \{)"
                      r".*?\n\}", r"\g<1> emu_mma(d, a, b); }", walk,
                      flags=re.S)
    if n != 1:
        raise RuntimeError("lstm_fwd32.cuh: mma16816 not found")
    walk = re.sub(r"k<<<(.*?), (4 \* H), (smem), st>>>\(args\.\.\.\);",
                  r"emu::launch(k, \1, \2, \3, args...);", walk)
    if "asm" in walk or "<<<" in walk:
        raise RuntimeError("lstm_fwd32.cuh: a device-only line is left")
    os.makedirs(out, exist_ok=True)
    for name, text in (("lstm_fwd32.cuh", walk),
                       ("cuda_runtime.h", HOST_CUDA),
                       ("cuda_bf16.h", HOST_BF16)):
        with open(os.path.join(out, name), "w") as fh:
            fh.write(text)
    infer = read("lstm_infer.cu").replace("#include <cuda_runtime.h>",
                                          '#include "cuda_runtime.h"')
    seq = cut(read("lstm_seq.cu"),
              "// ---- the fp32 single-direction forward (row 6a)",
              "template <int ND>\nint fwd_dtypes(")
    slab = cut(read("lstm_slab.cu"), "// ---- the fp32 forward (row 10a)",
               "// The backward's shared memory at")
    seq6b = once(read("lstm_seq_fwd_mixed.cu"), "#include <cuda_runtime.h>",
                 '#include "cuda_runtime.h"')
    src = os.path.join(out, "walk.cpp")
    with open(src, "w") as fh:
        fh.write(infer + "\nnamespace {\nusing bf16 = __nv_bfloat16;\n" + seq
                 + slab + "}\n" + seq6b + ENTRIES % {"smem": SMEM})
    return ctypes.CDLL(compile_lib(out, src, "libwalk.so"))


def build_bwd(out):
    """The host copy of the backward walk (rows 7 and 9,
    csrc/lstm_seq_bwd.cu) in out (after `build`, which writes the walk's
    header there), built; the library, called through its own C entry
    points."""
    bwd = once(read("lstm_seq_bwd.cu"), SHARED, HOST_SHARED)
    bwd = bwd.replace("#include <cuda_runtime.h>", '#include "cuda_runtime.h"')
    if "asm" in bwd or "<<<" in bwd:
        raise RuntimeError("lstm_seq_bwd.cu: a device-only line is left")
    src = os.path.join(out, "bwd.cpp")
    with open(src, "w") as fh:
        fh.write(bwd + STORAGE % {"smem": SMEM})
    return ctypes.CDLL(compile_lib(out, src, "libbwd.so"))


def compile_lib(out, src, name):
    lib = os.path.join(out, name)
    subprocess.run(["g++", "-std=c++20", "-O2", "-fPIC", "-shared",
                    "-pthread", "-I", out, "-o", lib, src], check=True)
    return lib


def build_stack(out):
    """The host copy of rows 1-4's cluster kernel (csrc/stack_walk.cu)
    in out (after `build`, which writes the walk's header there), built;
    the library: its cluster barrier is a std::barrier over the cluster's
    threads."""
    stack = once(read("stack_walk.cu"), "#include <cuda_runtime.h>",
                 '#include "cuda_runtime.h"')
    stack = once(stack, SHARED, HOST_SHARED)
    stack, n = re.subn(r"(void cp_async4\(void\* dst, const void\* src\) \{)"
                       r".*?\n\}", r"\g<1> std::memcpy(dst, src, 4); }", stack,
                       flags=re.S)
    if n != 1:
        raise RuntimeError("stack_walk.cu: cp_async4 not found")
    stack, n = re.subn(r"(void cp_async_wait_but_newest\(\) \{).*?\n\}",
                       r"\g<1> }", stack, flags=re.S)
    if n != 1:
        raise RuntimeError("stack_walk.cu: cp_async_wait_but_newest not "
                           "found")
    stack, n = re.subn(r"(void cluster_sync\(\) \{).*?\n\}",
                       r"\g<1> emu::cluster_bar->arrive_and_wait(); }",
                       stack, flags=re.S)
    if n != 1 or "asm" in stack:
        raise RuntimeError("stack_walk.cu: cluster_sync not found, or a "
                           "device-only line is left")
    src = os.path.join(out, "stack.cpp")
    with open(src, "w") as fh:
        fh.write(stack + STORAGE % {"smem": SMEM})
    return ctypes.CDLL(compile_lib(out, src, "libstack.so"))


# (name, NetConfig widths, use_film, steps) of rows 1-4's kernel: F = 17,
# 9 (blocks 5-7 own no row), 21 at H = 16, 145 (the flagship's widths,
# depth cut to 2), one block (the per-block route); with attention, chained
# past W so that pos wraps; conv_lstm (rows 2 and 4): F = 25 at s = 4 (a
# row past the last frame, blocks 6-7 own no frame), 145 at s = 5 (the
# Orange Pi and Raspberry Pi widths, depth cut to 2: seven blocks of four
# frames and one of one), 21 at s = 5 and H = 16 (one frame a block, the
# tail row on block 4)
STACK_CASES = (
    ("small", dict(stft_chunk_size=16, stft_pad_size=16, D=8, H=8, B=3),
     True, 2),
    ("f9", dict(stft_chunk_size=8, stft_pad_size=8, D=8, H=8, B=2), True, 1),
    ("h16", dict(stft_chunk_size=24, stft_pad_size=16, D=16, H=16, B=2),
     False, 1),
    ("flagship", dict(stft_chunk_size=192, stft_pad_size=96, D=32, H=64,
                      B=2), True, 1),
    ("block1", dict(stft_chunk_size=16, stft_pad_size=16, D=8, H=8, B=1),
     False, 1),
    ("attn_small", dict(stft_chunk_size=32, stft_pad_size=16, D=8, H=8, B=3,
                        L=2, E=2, local_atten_len=5, use_attn=True), True, 7),
    ("attn_flagship", dict(stft_chunk_size=192, stft_pad_size=96, D=32, H=64,
                           B=2, L=4, E=2, local_atten_len=3, use_attn=True),
     True, 4),
    ("conv_ragged", dict(stft_chunk_size=32, stft_pad_size=16, D=8, H=8, B=3,
                         conv_lstm=True, lstm_down=4), True, 2),
    ("conv_orangepi", dict(stft_chunk_size=192, stft_pad_size=96, D=24, H=64,
                           B=2, conv_lstm=True, lstm_down=5), False, 1),
    ("conv_raspberrypi", dict(stft_chunk_size=192, stft_pad_size=96, D=16,
                              H=64, B=2, conv_lstm=True, lstm_down=5),
     True, 1),
    ("conv_h16", dict(stft_chunk_size=24, stft_pad_size=16, D=16, H=16, B=2,
                      conv_lstm=True, lstm_down=5), True, 2),
    ("conv_attn_small", dict(stft_chunk_size=32, stft_pad_size=16, D=8, H=8,
                             B=3, L=2, E=2, local_atten_len=5, use_attn=True,
                             conv_lstm=True, lstm_down=4), True, 7),
    ("conv_attn_orangepi", dict(stft_chunk_size=192, stft_pad_size=96, D=24,
                                H=64, B=2, L=4, E=2, local_atten_len=3,
                                use_attn=True, conv_lstm=True, lstm_down=5),
     False, 4),
)


def stack_cases(lib, check, ptr):
    """`sbt_stack_walk` / `sbt_stack_walk_attn` under the emulation against
    `gridnet_stack_step_ref` / `_attn_ref`, each case's steps chained."""
    import numpy as np
    import torch

    from sound_bubble_tpu_torch.models.tfgridnet.model import Net, NetConfig
    from sound_bubble_tpu_torch.ops.kernels import stack_kernel as sk
    from sound_bubble_tpu_torch.weights import param_tree

    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sbt_stack_walk.argtypes = [P] * 25 + [I] * 7 + [ctypes.c_float, P]
    lib.sbt_stack_walk_attn.argtypes = ([P] * 43 + [I] * 11
                                        + [ctypes.c_float, P])
    lib.sbt_stack_walk_smem.argtypes = [I] * 7
    lib.sbt_stack_walk_smem.restype = ctypes.c_size_t
    lib.sbt_stack_walk_scratch.argtypes = [I] * 7
    lib.sbt_stack_walk_scratch.restype = ctypes.c_size_t
    for name, widths, use_film, steps in STACK_CASES:
        cfg = NetConfig(**{"conv_lstm": False, **widths})
        rng = np.random.default_rng(len(name))
        net = Net(cfg)
        net.load_state_dict({k: torch.from_numpy(np.asarray(
            rng.standard_normal(v.shape) * 0.3, np.float32))
            for k, v in net.state_dict().items()})
        tree = param_tree(net)
        packed = sk.pack_stack_params(cfg, tree)
        F, D, H, B = cfg.n_freqs, cfg.D, cfg.H, cfg.B

        def draw(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32))

        fw, fb = (draw(B - 1, F, D), draw(B - 1, F, D)) if use_film \
            else (None, None)
        h, c = draw(B, F, H) * 0.5, draw(B, F, H) * 0.5
        attn = None
        if cfg.use_attn:
            pa = sk.pack_attn_params(cfg, tree)
            W = cfg.local_atten_len
            attn = (cfg.L, cfg.E, W)
            rings = [torch.zeros(B, cfg.L * cfg.E, W, F),
                     torch.zeros(B, D, W, F)]
            rings_ref = [r.clone() for r in rings]
        s = sk.lstm_down(packed)
        plan = sk.walk_plan(F, D, H, B, attn, s)
        lib_plan = (lib.sbt_stack_walk_smem(F, D, H, s or 0,
                                            *(attn or (0, 0, 0))),
                    lib.sbt_stack_walk_scratch(B, F, D, H, s or 0, *(
                        (attn[0], attn[2]) if attn else (0, 0))))
        if lib_plan != (plan["smem"], plan["scratch"]):
            raise RuntimeError(f"{name}: the library's smem and scratch "
                               f"{lib_plan}, walk_plan's {plan}")
        hr, cr = h, c
        for step in range(steps):
            x = draw(F, D)
            outs = [torch.full((F, D), float("nan")),
                    torch.full((B, F, H), float("nan")),
                    torch.full((B, F, H), float("nan"))]
            scratch = torch.full((plan["scratch"],), float("nan"))
            weights = sk._operands(packed)[0]
            head = (ptr(x), ptr(fw), ptr(fb), *map(ptr, weights))
            tail = (ptr(h), ptr(c), *map(ptr, outs), ptr(scratch))
            dims = (B, F, D, H, s or 0)
            if attn is None:
                rc = lib.sbt_stack_walk(*head, *tail, *dims,
                                        int(use_film), plan["scratch"],
                                        cfg.eps, None)
                want = sk.gridnet_stack_step_ref(packed, x, hr, cr, fw, fb,
                                                 cfg.eps)
                got = outs
            else:
                pos = step % W
                rc = lib.sbt_stack_walk_attn(
                    *head, *[ptr(pa[k]) for k in sk._ATTN],
                    *map(ptr, rings), *tail, *dims, cfg.L, cfg.E, W, pos,
                    int(use_film), plan["scratch"], cfg.eps, None)
                want = sk.gridnet_stack_step_attn_ref(
                    packed, pa, x, hr, cr, *rings_ref, pos, cfg.L, fw, fb,
                    cfg.eps)
                got = outs + rings
            if rc:
                raise RuntimeError(f"{name}: the kernel refused the case "
                                   f"({rc})")
            check("stack", (name, step), got, want)
            h, c = outs[1], outs[2]
            hr, cr = want[1], want[2]


# the card's bars on the mixed kernels (chip_smoke.py's MIXED_REL_TOL and
# SEQ_MIXED_SHARE)
MIXED_REL_TOL = 1e-2
MIXED_SHARE = 0.05
# (rows, R, T, C, H) of the mixed cases: rows a block 1, 9, 19 with a
# ragged last tile, a ragged last slab, T = 1, the edge widths and
# C = H = 8; row 8b also at its one-wave 38 rows
MIXED_SLAB_CASES = ((1, 3, 10, 32, 64), (9, 19, 11, 32, 64),
                    (19, 40, 9, 32, 64), (9, 12, 5, 24, 64),
                    (5, 9, 1, 16, 64), (3, 7, 10, 8, 8))
MIXED_BSEQ_CASES = MIXED_SLAB_CASES + ((38, 77, 6, 32, 64),)


def mixed_cases(lib, ls, lk, check, draw, nan, ptr):
    """Rows 10b and 8b (the walk's mixed mode) under the emulation against
    `lstm_slab_fwd_ref` / `blstm_seq_fwd_ref`, bf16 x with bf16 (the
    tensor-core projection) and fp32 weights."""
    import numpy as np
    import torch

    bf = torch.bfloat16
    for code, wdt in ((1, bf), (2, torch.float32)):
        for rows, r, t_len, c, h in MIXED_SLAB_CASES:
            rng = np.random.default_rng(10 * rows + r)
            w = [draw(rng, *s, scale=h ** -0.5).to(wdt) for s in
                 ((c, 4 * h), (h, 4 * h), (4 * h,))]
            x = draw(rng, t_len, r, c).to(bf)
            h0, c0 = draw(rng, r, h, scale=0.5), draw(rng, r, h, scale=0.5)
            for rev in (False, True):
                want = ls.lstm_slab_fwd_ref(*w, x, h0, c0, rev)
                got = [nan(*t.shape).to(t.dtype) for t in want]
                if lib.emu_slab_fwd(x.data_ptr(), *map(ptr, w), ptr(h0),
                                    ptr(c0), *map(ptr, got), t_len, r, c, h,
                                    ls.n_slabs(t_len)[0], int(rev), rows,
                                    code):
                    raise RuntimeError("mixed slab refused the case")
                check("mixed_slab", (code, rows, r, t_len, c, h, rev), got,
                      want)
        for rows, r, t_len, c, h in MIXED_BSEQ_CASES:
            rng = np.random.default_rng(10 * rows + r + 1)
            w = [draw(rng, *s, scale=h ** -0.5).to(wdt) for s in
                 ((c, 4 * h), (h, 4 * h), (4 * h,)) * 2]
            x = draw(rng, t_len, r, c).to(bf)
            pack = lk._blstm_pack(dict(zip(("w_ih", "w_hh", "b"), w[:3])),
                                  dict(zip(("w_ih", "w_hh", "b"), w[3:])))
            want = lk.blstm_seq_fwd_ref(*pack, x)
            got = [nan(*t.shape).to(t.dtype) for t in want]
            if lib.emu_bseq_fwd_mixed(*map(ptr, (x, *pack)), *map(ptr, got),
                                      t_len, r, c, h, rows, code):
                raise RuntimeError("mixed bseq refused the case")
            check("mixed_bseq", (code, rows, r, t_len, c, h), got, want)


# (rows, R, T, C, H) of row 9's backward walk: rows a block 1, 19 and 38
# (its one-wave tiles at the training R), tails of 1-3 rows in the last
# group, a ragged last tile, T = 1, the edge widths, H = 8, 16, 32
BWD_CASES = ((1, 3, 10, 32, 64), (19, 40, 9, 32, 64), (38, 77, 6, 32, 64),
             (9, 12, 5, 24, 64), (5, 9, 1, 16, 64), (3, 7, 10, 8, 8),
             (2, 5, 7, 16, 16), (7, 15, 4, 32, 32), (13, 27, 3, 16, 64))
# tests/test_torch_port_cuda.py's SEQ_SHAPES (T, R, C, H) and its pairs
TEST_SEQ_SHAPES = {"ragged": (13, 37, 32, 64), "one": (1, 9, 32, 64),
                   "narrow": (11, 5, 8, 8), "wide": (9, 2504, 32, 64),
                   "c24": (13, 37, 24, 64), "c16": (13, 37, 16, 64)}
SEQ_TOL = 1e-4   # the card's fp32 bar on the seq kernels, of the peak


def mixed_seq_cases(lib, lk, check, draw, nan, ptr):
    """Row 6b (the walk's mixed mode SEQ) under the emulation against
    `lstm_seq_fwd_ref`, bf16 x with bf16 and fp32 weights."""
    import numpy as np
    import torch

    for code, wdt in ((1, torch.bfloat16), (2, torch.float32)):
        for rows, r, t_len, c, h in MIXED_SLAB_CASES:
            rng = np.random.default_rng(10 * rows + r + 2)
            w = [draw(rng, *s, scale=h ** -0.5).to(wdt) for s in
                 ((c, 4 * h), (h, 4 * h), (4 * h,))]
            x = draw(rng, t_len, r, c).to(torch.bfloat16)
            h0, c0 = draw(rng, r, h, scale=0.5), draw(rng, r, h, scale=0.5)
            want = lk.lstm_seq_fwd_ref(*w, x, h0, c0)
            got = [nan(*t.shape).to(t.dtype) for t in want]
            if lib.emu_seq_fwd_mixed(*map(ptr, (x, *w, h0, c0, *got)), t_len,
                                     r, c, h, rows, code):
                raise RuntimeError("mixed seq refused the case")
            check("mixed_seq", (code, rows, r, t_len, c, h), got, want)


def bwd_run(libb, pack, gates, c_seq, dy, code, rows):
    """Row 9's walk under the emulation: dgates."""
    import torch

    t_len, r, h2 = c_seq.shape
    got = torch.full((t_len, r, 4 * h2), float("nan")).to(dy.dtype)
    if libb.sbt_blstm_seq_bwd(gates.data_ptr(), c_seq.data_ptr(),
                              dy.data_ptr(), pack[2].data_ptr(),
                              got.data_ptr(), t_len, r, h2 // 2, code, rows,
                              None):
        raise RuntimeError("row 9 refused the case")
    return got


def seq_bwd_run(libb, w_hh, gates, c_seq, c0, dy, dhT, dcT, code, rows):
    """Row 7's walk under the emulation: (dgates, dh0, dc0)."""
    import torch

    t_len, r, h = c_seq.shape
    got = [torch.full((t_len, r, 4 * h), float("nan")).to(dy.dtype),
           torch.full((r, h), float("nan")), torch.full((r, h), float("nan"))]
    if libb.sbt_lstm_seq_bwd(gates.data_ptr(), c_seq.data_ptr(),
                             c0.data_ptr(), dy.data_ptr(), w_hh.data_ptr(),
                             dhT.data_ptr(), dcT.data_ptr(),
                             *(t.data_ptr() for t in got), t_len, r, h, code,
                             rows, None):
        raise RuntimeError("row 7 refused the case")
    return got


def bwd_cases(libb, lk, check, draw, ptr):
    """Rows 9 and 7 (csrc/lstm_seq_bwd.cu) under the emulation against
    `blstm_seq_bwd_ref` / `lstm_seq_bwd_ref` on the plain forwards' gates
    and c, in fp32 and both mixed pairs; row 7 from drawn (h0, c0, dhT,
    dcT)."""
    import numpy as np
    import torch

    for code, (xdt, wdt) in enumerate(lk.DTYPES):
        for rows, r, t_len, c, h in BWD_CASES:
            rng = np.random.default_rng(10 * rows + r + 3)
            w = [draw(rng, *s, scale=h ** -0.5).to(wdt) for s in
                 ((c, 4 * h), (h, 4 * h), (4 * h,)) * 2]
            x = draw(rng, t_len, r, c).to(xdt)
            pack = lk._blstm_pack(dict(zip(("w_ih", "w_hh", "b"), w[:3])),
                                  dict(zip(("w_ih", "w_hh", "b"), w[3:])))
            _, gates, c_seq = lk.blstm_seq_fwd_ref(*pack, x)
            dy = draw(rng, t_len, r, 2 * h).to(xdt)
            want = lk.blstm_seq_bwd_ref(pack[2], gates, c_seq, dy, xdt)
            got = bwd_run(libb, pack, gates, c_seq, dy, code, rows)
            check("bwd", (code, rows, r, t_len, c, h), [got], [want])
            h0, c0, dhT, dcT = (draw(rng, r, h, scale=0.5) for _ in range(4))
            _, gates, c_seq = lk.lstm_seq_fwd_ref(*w[:3], x, h0, c0)
            dy = dy[..., :h].contiguous()
            want = lk.lstm_seq_bwd_ref(gates, c_seq, c0, dy, dhT, dcT, w[1],
                                       xdt)
            got = seq_bwd_run(libb, w[1], gates, c_seq, c0, dy, dhT, dcT,
                              code, rows)
            check("bwd7", (code, rows, r, t_len, c, h), got, list(want))


def test_draws(shape, seed):
    """The operands of tests/test_torch_port_cuda.py's `_slab_case` on the
    CPU (the same draws in the same order)."""
    import numpy as np
    import torch

    t_len, r, c, h = shape
    rng = np.random.default_rng(seed)

    def draw(*s, scale=1.0):
        return torch.from_numpy((rng.standard_normal(s) * scale)
                                .astype(np.float32))

    return dict(w_ih=draw(c, 4 * h, scale=0.3), w_hh=draw(h, 4 * h, scale=0.3),
                b=draw(4 * h, scale=0.1), x=draw(t_len, r, c),
                h0=draw(r, h, scale=0.5), c0=draw(r, h, scale=0.5),
                dy=draw(t_len, r, h), dhT=draw(r, h), dcT=draw(r, h))


def seq_test_cases(lib, libb, ls, lk, check, nan, ptr):
    """Rows 6b, 7 and 9 at the exact draws of `test_seq_kernels_match_plain`
    (every shape and pair; rows a block as the wrappers pick them on 132
    SMs; row 7 on the plain forward's outputs, as the test), under the
    card's bars."""
    import torch

    for name, shape in TEST_SEQ_SHAPES.items():
        t_len, r, c, h = shape
        a, b = test_draws(shape, 0), test_draws(shape, 1)
        dy2 = torch.cat([a["dy"], b["dy"]], dim=-1)
        for code, (xdt, wdt) in enumerate(lk.DTYPES):
            w = [a[k].to(wdt) for k in ("w_ih", "w_hh", "b")]
            wb = [b[k].to(wdt) for k in ("w_ih", "w_hh", "b")]
            x = a["x"].to(xdt)
            if code:   # row 6b
                rows = ls.fwd_row_tiles(r, c, h, 132, 1, code, bseq=True)[0]
                want = lk.lstm_seq_fwd_ref(*w, x, a["h0"], a["c0"])
                got = [nan(*t.shape).to(t.dtype) for t in want]
                if lib.emu_seq_fwd_mixed(*map(ptr, (x, *w, a["h0"], a["c0"],
                                                    *got)), t_len, r, c, h,
                                         rows, code):
                    raise RuntimeError("mixed seq refused the case")
                check("test_row6b", (name, code, rows), got, want)
            _, gates, c_seq = lk.lstm_seq_fwd_ref(*w, x, a["h0"], a["c0"])
            dy = a["dy"].to(xdt)
            want = lk.lstm_seq_bwd_ref(gates, c_seq, a["c0"], dy, a["dhT"],
                                       a["dcT"], w[1], xdt)
            rows = lk.seq_bwd_row_tiles(r, h, code, 132, 1)[0]
            got = seq_bwd_run(libb, w[1], gates, c_seq, a["c0"], dy,
                              a["dhT"], a["dcT"], code, rows)
            check("test_row7", (name, code, rows), got, list(want))
            pack = lk._blstm_pack(dict(zip(("w_ih", "w_hh", "b"), w)),
                                  dict(zip(("w_ih", "w_hh", "b"), wb)))
            _, gates, c_seq = lk.blstm_seq_fwd_ref(*pack, x)
            dy = dy2.to(xdt)
            want = lk.blstm_seq_bwd_ref(pack[2], gates, c_seq, dy, xdt)
            rows = lk.seq_bwd_row_tiles(r, h, code, 132)[0]
            got = bwd_run(libb, pack, gates, c_seq, dy, code, rows)
            check("test_row9", (name, code, rows), [got], [want])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "_archive",
                                                  "emulate_fwd_walk"))
    ap.add_argument("--only",
                    default="infer,bseq,seq,slab,mixed,bwd,seqtest,stack")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    from sound_bubble_tpu_torch.ops.kernels import lstm_kernel as rk
    from sound_bubble_tpu_torch.ops.kernels import lstm_slab as ls
    from sound_bubble_tpu_torch.ops.kernels import lstm_train_kernel as lk

    lib = build(args.out)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sbt_blstm_infer.argtypes = [P] * 8 + [I] * 5 + [P]
    lib.emu_seq_fwd.argtypes = [P] * 10 + [I] * 6
    lib.emu_slab_fwd.argtypes = [P] * 10 + [I] * 8
    lib.emu_bseq_fwd_mixed.argtypes = [P] * 8 + [I] * 6
    lib.emu_seq_fwd_mixed.argtypes = [P] * 9 + [I] * 6
    torch.set_num_threads(1)
    only = args.only.split(",")
    worst = {}
    t0 = time.time()

    def ptr(t):
        return None if t is None else t.data_ptr()

    def check(kind, case, got, want):
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        print(kind, case, " ".join(f"{e:.2e}" for e in errs), flush=True)
        worst[kind] = max(worst.get(kind, 0.0), *errs)

    failed, checked = [], []

    def check_mixed(kind, case, got, want):
        """The card's bars: fp32 (row 9 and the tests' draws) each output
        within SEQ_TOL of its peak; mixed each output within MIXED_REL_TOL
        of its peak; slab: ys within one bf16 ulp of its peak everywhere;
        the seq walks: their bf16 outputs (y, gates; dgates) bit-equal at
        all but MIXED_SHARE of their elements."""
        rel = [float((g.float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-30)
               for g, w in zip(got, want)]
        fp32 = want[0].dtype == torch.float32
        ok = max(rel) <= (SEQ_TOL if fp32 else MIXED_REL_TOL) and all(
            g.dtype == w.dtype for g, w in zip(got, want))
        checked.append(kind)
        if fp32:
            extra = ""
        elif kind == "mixed_slab":
            peak = float(want[0].float().abs().max())
            ulp = 2.0 ** (np.floor(np.log2(peak)) - 7)
            n_ulp = int(((got[0].float() - want[0].float()).abs()
                         > ulp).sum())
            extra = f"ys past one ulp of its peak: {n_ulp}"
            ok = ok and n_ulp == 0
        else:
            shares = [float((g != w).float().mean()) for g, w in
                      zip(got[:2], want[:2]) if w.dtype == torch.bfloat16]
            extra = f"share differing (y, gates; dgates) {shares}"
            ok = ok and max(shares) <= MIXED_SHARE
        print(kind, case, "max-abs / peak", " ".join(f"{e:.2e}" for e in rel),
              extra, "ok" if ok else "FAILS", flush=True)
        if not ok:
            failed.append((kind, case))

    def draw(rng, *shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))

    def nan(*shape):
        return torch.full(shape, float("nan"))

    if "infer" in only:   # (rows, R, T, C), H = 64
        for rows, r, t_len, c in ((1, 1, 145, 32), (1, 3, 29, 24),
                                  (2, 3, 13, 32), (3, 7, 9, 16),
                                  (4, 9, 11, 32), (4, 4, 1, 32),
                                  (5, 6, 10, 32), (1, 2, 8, 16)):
            rng = np.random.default_rng(100 * rows + r)
            p = {d: {"w_ih": draw(rng, c, 256, scale=0.125),
                     "w_hh": draw(rng, 64, 256, scale=0.125),
                     "b": draw(rng, 256, scale=0.25)}
                 for d in ("fwd", "bwd")}
            x = draw(rng, r, t_len, c)
            y = nan(r, t_len, 128)
            ws = [p[d][k] for d in ("fwd", "bwd") for k in ("w_ih", "w_hh",
                                                           "b")]
            if lib.sbt_blstm_infer(x.data_ptr(), *map(ptr, ws), y.data_ptr(),
                                   t_len, r, c, 64, rows, None):
                raise RuntimeError("sbt_blstm_infer refused the case")
            check("infer", (rows, r, t_len, c), [y],
                  [rk.blstm_infer_ref(p, x)])
    for nd, kind in ((2, "bseq"), (1, "seq")):
        if kind not in only:
            continue
        cases = [(rows, 2 * rows + 1, 10, 32)
                 for rows in range(1, 20, 1 if nd == 2 else 3)]
        cases += [(1, 3, 1, 32), (2, 5, 9, 24), (3, 7, 12, 16),
                  (5, 9, 13, 8)]
        for rows, r, t_len, c in cases:
            h = 8 if c == 8 else 64
            rng = np.random.default_rng(7 * rows + r)
            w = [draw(rng, *s, scale=h ** -0.5) for s in
                 ((c, 4 * h), (h, 4 * h), (4 * h,)) * 2]
            x = draw(rng, t_len, r, c)
            h0 = c0 = None
            if nd == 2:
                pack = lk._blstm_pack(dict(zip(("w_ih", "w_hh", "b"), w[:3])),
                                      dict(zip(("w_ih", "w_hh", "b"), w[3:])))
                want = lk.blstm_seq_fwd_ref(*pack, x)
                operands = (x, pack[0], pack[1], pack[2], pack[3])
            else:
                h0, c0 = draw(rng, r, h, scale=0.5), draw(rng, r, h, scale=0.5)
                want = lk.lstm_seq_fwd_ref(*w[:3], x, h0, c0)
                operands = (x, w[0], w[0], w[1], w[2])
            got = [nan(*t.shape) for t in want]
            if lib.emu_seq_fwd(*map(ptr, operands), ptr(h0), ptr(c0),
                               *map(ptr, got), t_len, r, c, h, nd, rows):
                raise RuntimeError(f"{kind} refused the case")
            check(kind, (rows, r, t_len, c), got, want)
    if "slab" in only:
        for rows, r, t_len, c in ((1, 3, 10, 32), (4, 9, 17, 32),
                                  (7, 15, 9, 24), (10, 21, 8, 32),
                                  (13, 27, 12, 16)):
            rng = np.random.default_rng(rows)
            w = [draw(rng, *s, scale=0.125) for s in
                 ((c, 256), (64, 256), (256,))]
            x = draw(rng, t_len, r, c)
            h0, c0 = draw(rng, r, 64, scale=0.5), draw(rng, r, 64, scale=0.5)
            for rev in (False, True):
                want = ls.lstm_slab_fwd_ref(*w, x, h0, c0, rev)
                got = [nan(*t.shape) for t in want]
                if lib.emu_slab_fwd(x.data_ptr(), *map(ptr, w), ptr(h0),
                                    ptr(c0), *map(ptr, got), t_len, r, c,
                                    64, ls.n_slabs(t_len)[0], int(rev),
                                    rows, 0):
                    raise RuntimeError("slab refused the case")
                check("slab", (rows, r, t_len, c, rev), got, want)
    if "mixed" in only:
        mixed_cases(lib, ls, lk, check_mixed, draw, nan, ptr)
        mixed_seq_cases(lib, lk, check_mixed, draw, nan, ptr)
    if "bwd" in only or "seqtest" in only:
        libb = build_bwd(args.out)
        libb.sbt_blstm_seq_bwd.argtypes = [P] * 5 + [I] * 5 + [P]
        libb.sbt_lstm_seq_bwd.argtypes = [P] * 10 + [I] * 5 + [P]
        if "bwd" in only:
            bwd_cases(libb, lk, check_mixed, draw, ptr)
        if "seqtest" in only:
            seq_test_cases(lib, libb, ls, lk, check_mixed, nan, ptr)
    if "stack" in only:
        stack_cases(build_stack(args.out), check, ptr)
    print(f"worst max-abs {worst} (tol {TOL}), mixed cases past the card's "
          f"bars: {failed}, {time.time() - t0:.1f} s")
    if (not worst and not checked) or max(worst.values(), default=0.0) > TOL \
            or failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
