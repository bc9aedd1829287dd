"""Run the fp32 LSTM forward walk (`sound_bubble_tpu_torch/csrc/
lstm_fwd32.cuh`) on the CPU, in all four of its kernels, against the plain
versions: a check of the kernels' logic where there is no card and no nvcc.

    python tools/emulate_fwd_walk.py [--out DIR] [--only infer,bseq,seq,slab]

Copies the header and the kernels that include it (row 5's
`csrc/lstm_infer.cu`; rows 6a and 8a from `csrc/lstm_seq.cu`, row 10a from
`csrc/lstm_slab.cu`, cut out between their section comments) into DIR
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
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct uint3e { unsigned x, y, z; };
inline thread_local uint3e threadIdx, blockIdx;
using std::max;
using std::min;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline int cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) {
  return 0;
}
inline int cudaGetLastError() { return 0; }

namespace emu {
struct Warp {
  std::barrier<>* bar;
  float buf[32];
};
inline thread_local std::barrier<>* block_bar;
inline thread_local Warp* warp;
inline thread_local int lane;
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
        block_bar = &bar;
        warp = &warps[t / 32];
        lane = t % 32;
        k(args...);
      });
    for (auto& th : ts) th.join();
    for (auto& w : warps) delete w.bar;
  }
}
}  // namespace emu

inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int m) {
  emu::warp->buf[emu::lane] = v;
  emu::warp->bar->arrive_and_wait();
  const float r = emu::warp->buf[emu::lane ^ m];
  emu::warp->bar->arrive_and_wait();
  return r;
}
"""

ENTRIES = r"""
namespace sbt_fwd32 { alignas(16) unsigned char smem[%(smem)d]; }
namespace emu {
unsigned char* smem_base = sbt_fwd32::smem;
size_t smem_cap = %(smem)d;
}
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
                            int kf, int reverse, int rows) {
  return slab_fwd32(x, w_ih, w_hh, b, h0, c0, ys, hT, cT, c_ckpt, T, R, C, H,
                    kf, reverse, rows, nullptr);
}
"""


def cut(text, start, end):
    i = text.index(start)
    return text[i:text.index(end, i)]


def once(text, old, new):
    if text.count(old) != 1:
        raise RuntimeError(f"{old[:60]!r} found {text.count(old)} times")
    return text.replace(old, new)


def build(out):
    """The host copy of the walk's kernels in out, built; the library."""
    csrc = os.path.join(REPO, "sound_bubble_tpu_torch", "csrc")

    def read(name):
        with open(os.path.join(csrc, name)) as fh:
            return fh.read()

    walk = once(read("lstm_fwd32.cuh"),
                'asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));',
                "r = 1.0f / d;")
    for fn, body in (("cp_async16(void* dst, const void* src)",
                      " std::memcpy(dst, src, 16); "),
                     ("cp_async_commit()", ""), ("cp_async_wait_all()", "")):
        walk, n = re.subn(r"(void " + re.escape(fn) + r" \{).*?\n\}",
                          r"\g<1>" + body + "}", walk, flags=re.S)
        if n != 1:
            raise RuntimeError(f"lstm_fwd32.cuh: {fn} not found")
    walk = re.sub(r"k<<<(.*?), (4 \* H), (smem), st>>>\(args\.\.\.\);",
                  r"emu::launch(k, \1, \2, \3, args...);", walk)
    if "asm" in walk or "<<<" in walk:
        raise RuntimeError("lstm_fwd32.cuh: a device-only line is left")
    os.makedirs(out, exist_ok=True)
    for name, text in (("lstm_fwd32.cuh", walk),
                       ("cuda_runtime.h", HOST_CUDA)):
        with open(os.path.join(out, name), "w") as fh:
            fh.write(text)
    infer = read("lstm_infer.cu").replace("#include <cuda_runtime.h>",
                                          '#include "cuda_runtime.h"')
    seq = cut(read("lstm_seq.cu"),
              "// ---- the fp32 single-direction forward (row 6a)",
              "template <int ND, typename XT, typename WT>\nint seq_bwd(")
    slab = cut(read("lstm_slab.cu"), "// ---- the fp32 forward (row 10a)",
               "// The backward's shared memory at")
    src = os.path.join(out, "walk.cpp")
    with open(src, "w") as fh:
        fh.write(infer + "\nnamespace {\n" + seq + slab + "}\n"
                 + ENTRIES % {"smem": SMEM})
    lib = os.path.join(out, "libwalk.so")
    subprocess.run(["g++", "-std=c++20", "-O2", "-fPIC", "-shared",
                    "-pthread", "-I", out, "-o", lib, src], check=True)
    return ctypes.CDLL(lib)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "_archive",
                                                  "emulate_fwd_walk"))
    ap.add_argument("--only", default="infer,bseq,seq,slab")
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
    lib.emu_slab_fwd.argtypes = [P] * 10 + [I] * 7
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
                                    rows):
                    raise RuntimeError("slab refused the case")
                check("slab", (rows, r, t_len, c, rev), got, want)
    print(f"worst max-abs {worst} (tol {TOL}), {time.time() - t0:.1f} s")
    if not worst or max(worst.values()) > TOL:
        sys.exit(1)


if __name__ == "__main__":
    main()
