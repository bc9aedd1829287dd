"""Split one block's cycles of the LSTM forwards on the walk of
`sound_bubble_tpu_torch/csrc/lstm_fwd32.cuh` (rows 5, 6a, 8a, 10a and the
mixed 8b and 10b) by phase, on one card.

    python tools/split_fwd_cycles.py [OUT_DIR]

Copies this checkout's `sound_bubble_tpu_torch/` into OUT_DIR (default
`_archive/split_fwd`, listed in .gitignore), stamps `clock64()` at thread
0's phase boundaries in the copy's `lstm_fwd32.cuh` (summed in static
shared memory, added into a `__device__` array at the block's end and read
back through an extra C entry point a source), builds the copy and runs the
slab forward at the flagship's intra [145, 1252, 32] and inter
[313, 580, 32] shapes, the seq forward at the inter shape, its
fused-direction forward (row 8a) at the intra shape, row 5's whole
function at one stream ([R, T, C] = [1, 145, 32]) and, mixed (bf16 x and
weights), the slab forward and the fused-direction forward at the bf16
recipe's intra shape [145, 2504, 32] and the seq forward (row 6b, also with
fp32 weights) at its inter shape [313, 1160, 32]. Prints the
card's name and power limit, then one JSON line a shape: cycles a frame of
thread 0's block and their split (the x tile's wait and the slab's first
barrier; the projection and c_ckpt; the second barrier and the next x
tile's copy; the h . W_hh FMAs; the reduce; the cells and their stores; the
frame's barrier). The stamps slow the kernel by ~15 %; the shares, not the
times, are what it measures. Needs one NVIDIA card.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("wait x + barrier", "project + ckpt", "barrier + load_x",
          "h.W FMA", "reduce", "cell", "frame barrier")
# (kernel, T, R, C, (x, weights) pair code of lstm_slab.DTYPES) timed; the
# mixed pairs at the bf16 recipe's batch 8 (rows 10b, 8b and 6b)
SHAPES = (("slab", 145, 1252, 32, 0), ("slab", 313, 580, 32, 0),
          ("seq", 313, 580, 32, 0), ("bseq", 145, 1252, 32, 0),
          ("infer", 145, 1, 32, 0), ("slab", 145, 2504, 32, 1),
          ("bseq", 145, 2504, 32, 1), ("seq", 313, 1160, 32, 1),
          ("seq", 313, 1160, 32, 2))
STAMP = ("#define ST(i, t0) do { if (threadIdx.x == 0) { long long _n = "
         "clock64(); sacc[i] += _n - t0; t0 = _n; } } while (0)\n")
# (text of lstm_fwd32.cuh, its instrumented replacement), each found once
EDITS = (
    ("namespace sbt_fwd32 {\n",
     "namespace sbt_fwd32 {\nstatic __device__ unsigned long long "
     "g_split[16];\n" + STAMP),
    ("    int rows, int rt, size_t base, size_t sbase, int T, const O& o,\n"
     "    float4 bc) {\n  using D = Dims<H>;\n",
     "    int rows, int rt, size_t base, size_t sbase, int T, const O& o,\n"
     "    float4 bc, unsigned long long* sacc) {\n"
     "  using D = Dims<H>;\n  long long t0 = clock64();\n"),
    ("  int rho[3] = {0, 0, 0};", "  ST(3, t0);\n  int rho[3] = {0, 0, 0};"),
    ("  cell<H, M, P>(v[0], g + rho[0]", "  ST(4, t0);\n  cell<H, M, P>(v[0], "
     "g + rho[0]"),
    ("                  rt, base, sbase, T, o, bc);\n}",
     "                  rt, base, sbase, T, o, bc);\n  ST(5, t0);\n}"),
    ("                                    base, sbase, T, o, bc);",
     "                                    base, sbase, T, o, bc, sacc);"),
    ("                               base, sbase, T, o, bc);                 "
     "      \\",
     "                               base, sbase, T, o, bc, sacc);           "
     "      \\"),
    ("  const int nb = (T + kf - 1) / kf;\n",
     "  const int nb = (T + kf - 1) / kf;\n  __shared__ unsigned long long "
     "sacc[8];\n  if (tid < 8) sacc[tid] = 0;\n  const long long t_begin = "
     "clock64();\n"),
    ("    cp_async_wait_all();\n    __syncthreads();",
     "    long long t0 = clock64();\n    cp_async_wait_all();\n"
     "    __syncthreads();\n    ST(0, t0);"),
    ("    __syncthreads();  // gx is in; the x tile and c are free\n"
     "    if (js + 1 < nb) load_x(js + 1);",
     "    ST(1, t0);\n    __syncthreads();\n    if (js + 1 < nb) "
     "load_x(js + 1);\n    ST(2, t0);"),
    ("      __syncthreads();  // h of this frame is in hn\n",
     "      long long tf = clock64();\n      __syncthreads();\n"
     "      ST(6, tf);\n"),
    ("  if constexpr (M == SLAB) {\n    const float* hl",
     "  if (tid == 0) {\n    sacc[7] = clock64() - t_begin;\n    for (int i "
     "= 0; i < 8; ++i) atomicAdd(&g_split[i], sacc[i]);\n    "
     "atomicAdd(&g_split[8], 1ull);\n  }\n  if constexpr (M == SLAB) {\n"
     "    const float* hl"),
)
READER = """
extern "C" int {name}(unsigned long long* out) {{
  int err = (int)cudaMemcpyFromSymbol(out, sbt_fwd32::g_split,
                                      sizeof(unsigned long long) * 16);
  unsigned long long z[16] = {{0}};
  cudaMemcpyToSymbol(sbt_fwd32::g_split, z, sizeof(z));
  return err;
}}
"""


def instrument(out_dir):
    """A copy of the package in out_dir with the stamps; raises if the
    walk's source no longer has a line the stamps go beside."""
    pkg = os.path.join(out_dir, "sound_bubble_tpu_torch")
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "sound_bubble_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = os.path.join(pkg, "csrc")
    path = os.path.join(csrc, "lstm_fwd32.cuh")
    src = open(path).read()
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"lstm_fwd32.cuh: {old[:50]!r} found "
                               f"{src.count(old)} times, not once")
        src = src.replace(old, new)
    open(path, "w").write(src)
    for name, reader in (("lstm_slab.cu", "sbt_split_slab"),
                         ("lstm_seq.cu", "sbt_split_seq"),
                         ("lstm_seq_fwd_mixed.cu", "sbt_split_seq6b"),
                         ("lstm_infer.cu", "sbt_split_infer")):
        with open(os.path.join(csrc, name), "a") as fh:
            fh.write(READER.format(name=reader))
    return out_dir


def child(out_dir):
    sys.path.insert(0, out_dir)
    import numpy as np
    import torch

    from sound_bubble_tpu_torch.ops.kernels import _build
    from sound_bubble_tpu_torch.ops.kernels import lstm_kernel as rk
    from sound_bubble_tpu_torch.ops.kernels import lstm_slab as ls
    from sound_bubble_tpu_torch.ops.kernels import lstm_train_kernel as lk

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    dev = torch.device("cuda")
    lib = _build.load_library()
    # each source keeps stamps of its own: row 6b's is lstm_seq_fwd_mixed.cu
    readers = {"slab": lib.sbt_split_slab, "seq": lib.sbt_split_seq,
               "seq6b": lib.sbt_split_seq6b, "bseq": lib.sbt_split_seq,
               "infer": lib.sbt_split_infer}
    for fn in readers.values():
        fn.argtypes = [ctypes.c_void_p]
    h = 64
    for kind, t_len, r, c, code in SHAPES:
        rng = np.random.default_rng(0)
        xdt, wdt = ls.DTYPES[code]

        def draw(*shape, scale=1.0, dtype=wdt):
            return torch.from_numpy((rng.standard_normal(shape) * scale)
                                    .astype(np.float32)).to(dev, dtype)

        args = (draw(c, 4 * h, scale=h ** -0.5),
                draw(h, 4 * h, scale=h ** -0.5), draw(4 * h, scale=h ** -0.5),
                draw(t_len, r, c, dtype=xdt),
                draw(r, h, scale=0.5, dtype=torch.float32),
                draw(r, h, scale=0.5, dtype=torch.float32))

        p = [dict(zip(("w_ih", "w_hh", "b"), args[:3])),
             dict(zip(("w_ih", "w_hh", "b"), (a.flip(0) for a in args[:3])))]

        def run():
            with torch.no_grad():
                if kind == "slab":
                    ls.lstm_slab_fwd(*args, False)
                elif kind == "seq":
                    lk.lstm_seq_fwd(*args)
                elif kind == "bseq":
                    lk.blstm_seq_fwd(*lk._blstm_pack(*p), args[3])
                else:   # row 5 takes x [R, T, C]
                    rk.blstm_infer({"fwd": p[0], "bwd": p[1]},
                                   args[3].transpose(0, 1).contiguous())
            torch.cuda.synchronize()

        sums = (ctypes.c_ulonglong * 16)()
        run()
        reader = readers["seq6b" if kind == "seq" and code else kind]
        reader(ctypes.cast(sums, ctypes.c_void_p))
        run()
        reader(ctypes.cast(sums, ctypes.c_void_p))
        per = [v / sums[8] / t_len for v in sums[:8]]
        print(json.dumps({
            "kernel": kind, "shape": [t_len, r, c],
            "pair": [str(xdt), str(wdt)],
            "blocks": sums[8],
            "cycles_per_frame": round(per[7], 1),
            "split": {p: round(v, 1) for p, v in zip(PHASES, per)},
            "share": {p: round(v / per[7], 3) for p, v in zip(PHASES, per)},
        }), flush=True)


def main(out_dir):
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    instrument(out_dir)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--child", out_dir], timeout=600)
    sys.exit(proc.returncode)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
    else:
        main(os.path.abspath(sys.argv[1] if sys.argv[1:] else
                             os.path.join(REPO, "_archive", "split_fwd")))
