"""Split one block's cycles of the custom-VJP route's backward walks by
phase, on one card: the backward walk (`seq_bbwd_kernel`,
`csrc/lstm_seq_bwd.cu`: row 9 and, where its walk takes a direction count,
row 7) and, in an older tree, the first design (`seq_bwd_kernel` in
`sound_bubble_tpu_torch/csrc/lstm_seq.cu`: row 7, and row 9 in a tree
older than `csrc/lstm_seq_bwd.cu`).

    python tools/split_bwd_cycles.py [TREE] [OUT_DIR]

TREE holds a `sound_bubble_tpu_torch/` (default: this checkout). Copies its
package into OUT_DIR (default `_archive/split_bwd`, listed in .gitignore),
stamps `clock64()` at thread 0's phase boundaries in the copy (summed in
static shared memory, added into a `__device__` array at the block's end
and read back through an extra C entry point a source), builds the copy
and runs the backward of row 9 in fp32 at the flagship's intra shape
[145, 1252] and mixed (bf16 x, bf16 and fp32 weights) at the bf16 recipe's
[145, 2504], and of row 7 in fp32 at the inter shape [313, 580] and mixed
(both pairs) at [313, 1160]; H = 64. Prints the card's name and power
limit, then one JSON line a shape: cycles a frame of thread 0's block and
their split. The
first design's phases: the frame's loads, cells and stores; its barrier;
the dh dot over the gate gradients in shared memory. The walk's: the next
frame's copies issued; the chain (FMAs, or with bf16 weights mma.sync);
the FMA chain's reduce over lanes; the cells and their stores; the wait for
the copies and the frame's barrier. The stamps slow
the kernels; the shares, not the times, are what it measures. Needs one
NVIDIA card.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIRST = ("loads + cell", "barrier", "dh dot")
WALK = ("wait + frame barrier", "issue copies", "chain", "reduce", "cell")
# (row, T, R, (x, weights) pair code of lstm_slab.DTYPES)
SHAPES = (("9", 145, 1252, 0), ("9", 145, 2504, 1), ("9", 145, 2504, 2),
          ("7", 313, 580, 0), ("7", 313, 1160, 1), ("7", 313, 1160, 2))
STAMP = ("#define ST(i, t0) do { if (threadIdx.x == 0) { long long _n = "
         "clock64(); sacc[i] += _n - t0; t0 = _n; } } while (0)\n")
HEAD = ("static __device__ unsigned long long g_split[16];\n"
        "static __shared__ unsigned long long sacc[8];\n" + STAMP)
TAIL = ("  if (tid == 0) {\n    sacc[7] = clock64() - t_begin;\n    for (int "
        "i = 0; i < 8; ++i) atomicAdd(&g_split[i], sacc[i]);\n    "
        "atomicAdd(&g_split[8], 1ull);\n  }\n")
BEGIN = ("  if (tid < 8) sacc[tid] = 0;\n"
         "  const long long t_begin = clock64();\n")
# (text, its instrumented replacement) of lstm_seq.cu's first design
FIRST_EDITS = (
    ("namespace {\n", "namespace {\n" + HEAD),
    ("  const int j = tid % H, grp = (tid / H) % G, d = tid / (G * H);\n"
     "  const int r0 = blockIdx.x * RT;\n",
     "  const int j = tid % H, grp = (tid / H) % G, d = tid / (G * H);\n"
     "  const int r0 = blockIdx.x * RT;\n" + BEGIN),
    ("  const float* wT = whhT + d * H4 * H;\n  for (int n = 0; n < T; ++n) "
     "{\n",
     "  const float* wT = whhT + d * H4 * H;\n  for (int n = 0; n < T; ++n) "
     "{\n    long long t0 = clock64();\n"),
    ("    __syncthreads();\n    // dh entering this step",
     "    ST(0, t0);\n    __syncthreads();\n    ST(1, t0);\n"
     "    // dh entering this step"),
    ("    for (int q = 0; q < RPT; ++q) dh[q] = acc[q];\n  }\n",
     "    for (int q = 0; q < RPT; ++q) dh[q] = acc[q];\n    ST(2, t0);\n"
     "  }\n" + TAIL),
)
# the same for lstm_seq_bwd.cu's walk (count: how often the text is there;
# the FMA and the tensor cores' chain each have a frame loop): the stamps
# every version of the walk takes, then those of the walk of rows 7 and 9
# (ROW79_EDITS) or of an older walk of row 9 alone (ROW9_EDITS)
WALK_EDITS = (
    ("namespace sbt_bwd {\n", "namespace sbt_bwd {\n" + HEAD),
    ("  constexpr int N = NA + NB + NC, DS = 4 * H + 8;\n",
     "  constexpr int N = NA + NB + NC, DS = 4 * H + 8;\n"
     "  long long t0 = clock64();\n"),
    ("  int rho[3] = {0, 0, 0}, ub[3] = {0, 0, 0};",
     "  ST(2, t0);\n  int rho[3] = {0, 0, 0}, ub[3] = {0, 0, 0};"),
    ("  constexpr int DS = 4 * H + 8;\n  const int lane = threadIdx.x & 31, "
     "g = lane >> 2, t = lane & 3;\n",
     "  constexpr int DS = 4 * H + 8;\n  const int lane = threadIdx.x & 31, "
     "g = lane >> 2, t = lane & 3;\n  long long t0 = clock64();\n"),
    ("  }\n#pragma unroll\n  for (int m = 0; m < NMT; ++m) {\n"
     "    const int r = 16 * (mt0 + m) + g",
     "  }\n  ST(2, t0);\n#pragma unroll\n  for (int m = 0; m < NMT; ++m) {\n"
     "    const int r = 16 * (mt0 + m) + g"),
    ("  const int row0 = tile * rows, rt = min(rows, R - row0);\n",
     "  const int row0 = tile * rows, rt = min(rows, R - row0);\n" + BEGIN),
    ("      if (n + 1 < T) load(n + 1);\n",
     "      long long tl = clock64();\n      if (n + 1 < T) load(n + 1);\n"
     "      ST(1, tl);\n", 2),
    ("      cp_async_wait_all();\n      __syncthreads();  // the next frame's "
     "tiles are in; this dg tile is done\n",
     "      long long tf = clock64();\n      cp_async_wait_all();\n"
     "      __syncthreads();\n      ST(0, tf);\n", 2),
)
ROW79_EDITS = (
    ("  if constexpr (MODE == FIN) {\n    static_assert",
     "  ST(3, t0);\n  if constexpr (MODE == FIN) {\n    static_assert"),
    ("                       rows, rt, f);\n  }\n}\n",
     "                       rows, rt, f);\n  }\n  ST(4, t0);\n}\n"),
    ("      cell<H, true, MODE>(d[m][3], r + 8, true, u + 1, rows, rt, f);\n"
     "    }\n  }\n}",
     "      cell<H, true, MODE>(d[m][3], r + 8, true, u + 1, rows, rt, f);\n"
     "    }\n  }\n  ST(4, t0);\n}"),
    # the block's end: before row 7's dc0 store
    ("  if (dc0)  // row 7: dc after the last frame\n",
     TAIL + "  if (dc0)  // row 7: dc after the last frame\n"),
)
ROW9_EDITS = (
    ("  cell<H, M>(v[0], g + rho[0]", "  ST(3, t0);\n  cell<H, M>(v[0], "
     "g + rho[0]"),
    ("    cell<H, M>(v[2], g + NA + NB + rho[2], own[2], m0 + ub[2], rows, "
     "rt, f);\n}",
     "    cell<H, M>(v[2], g + NA + NB + rho[2], own[2], m0 + ub[2], rows, "
     "rt, f);\n  ST(4, t0);\n}"),
    ("    cell<H, true>(d[m][3], r + 8, true, u + 1, rows, rt, f);\n  }\n}",
     "    cell<H, true>(d[m][3], r + 8, true, u + 1, rows, rt, f);\n  }\n"
     "  ST(4, t0);\n}"),
    ("    }\n  }\n}\n\ntemplate <typename XT, typename WT>\nint bbwd(",
     "    }\n  }\n" + TAIL + "}\n\ntemplate <typename XT, "
     "typename WT>\nint bbwd("),
)
READER = """
extern "C" int {name}(unsigned long long* out) {{
  int err = (int)cudaMemcpyFromSymbol(out, {ns}::g_split,
                                      sizeof(unsigned long long) * 16);
  unsigned long long z[16] = {{0}};
  cudaMemcpyToSymbol({ns}::g_split, z, sizeof(z));
  return err;
}}
"""


def edit(path, edits, reader, ns):
    """Apply the stamps to the source at path and append its reader;
    raises if the source no longer has a line the stamps go beside."""
    src = open(path).read()
    for old, new, *count in edits:
        want = count[0] if count else 1
        if src.count(old) != want:
            raise RuntimeError(f"{os.path.basename(path)}: {old[:50]!r} "
                               f"found {src.count(old)} times, not {want}")
        src = src.replace(old, new)
    with open(path, "w") as fh:
        fh.write(src + READER.format(name=reader, ns=ns))


def instrument(tree, out_dir):
    """A stamped copy of the tree's package in out_dir; the rows ("7",
    "9") its walk runs."""
    pkg = os.path.join(out_dir, "sound_bubble_tpu_torch")
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "sound_bubble_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = os.path.join(pkg, "csrc")
    seq = os.path.join(csrc, "lstm_seq.cu")
    if "seq_bwd_kernel" in open(seq).read():
        # the first design's anonymous namespace is the file's own
        edit(seq, FIRST_EDITS, "sbt_split_first", "")
    walk = os.path.join(csrc, "lstm_seq_bwd.cu")
    if not os.path.exists(walk):
        return ""
    nd = "int nd," in open(walk).read()
    edit(walk, WALK_EDITS + (ROW79_EDITS if nd else ROW9_EDITS),
         "sbt_split_walk", "sbt_bwd")
    return "79" if nd else "9"


def child(out_dir, walk_rows):
    sys.path.insert(0, out_dir)
    import numpy as np
    import torch

    from sound_bubble_tpu_torch.ops.kernels import _build
    from sound_bubble_tpu_torch.ops.kernels import lstm_slab as ls
    from sound_bubble_tpu_torch.ops.kernels import lstm_train_kernel as lk

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    dev = torch.device("cuda")
    lib = _build.load_library()
    readers = {}
    if hasattr(lib, "sbt_split_first"):
        readers["first"] = lib.sbt_split_first
    if walk_rows:
        readers["walk"] = lib.sbt_split_walk
    for fn in readers.values():
        fn.argtypes = [ctypes.c_void_p]
    h = 64
    for row, t_len, r, code in SHAPES:
        xdt, wdt = ls.DTYPES[code]
        nd = 2 if row == "9" else 1
        rng = np.random.default_rng(0)

        def draw(*shape, lo=-1.0, hi=1.0, dtype=torch.float32):
            return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
                np.float32)).to(dev, dtype)

        gates = draw(t_len, r, nd * 4 * h, lo=0.0, dtype=xdt if code else
                     torch.float32)
        c_seq, dy = draw(t_len, r, nd * h), draw(t_len, r, nd * h, dtype=xdt)
        w_hh = draw(nd * h, nd * 4 * h, lo=-0.125, hi=0.125, dtype=wdt)
        # row 7's c0, dy, dhT, dcT
        ends = (draw(r, h), dy, draw(r, h), draw(r, h))

        def run():
            with torch.no_grad():
                if nd == 2:
                    lk.blstm_seq_bwd(w_hh, gates, c_seq, dy, xdt)
                else:
                    lk.lstm_seq_bwd(gates, c_seq, *ends, w_hh, xdt)
            torch.cuda.synchronize()

        kind = "walk" if row in walk_rows else "first"
        phases = WALK if kind == "walk" else FIRST
        sums = (ctypes.c_ulonglong * 16)()
        run()
        readers[kind](ctypes.cast(sums, ctypes.c_void_p))
        run()
        readers[kind](ctypes.cast(sums, ctypes.c_void_p))
        per = [v / sums[8] / t_len for v in sums[:8]]
        if kind == "first":
            tiles = (8, -(-r // 8))
        elif nd == 2:
            tiles = lk.seq_bwd_row_tiles(r, h, code, ls._n_sm(dev))
        else:
            tiles = lk.seq_bwd_row_tiles(r, h, code, ls._n_sm(dev), nd)
        print(json.dumps({
            "row": row + ("a" if not code else "b"), "kernel": kind,
            "pair": [str(xdt), str(wdt)], "shape": [t_len, r, h],
            "rows_a_block": tiles[0], "blocks": sums[8],
            "cycles_per_frame": round(per[7], 1),
            "split": {p: round(per[i], 1) for i, p in enumerate(phases)},
            "share": {p: round(per[i] / per[7], 3)
                      for i, p in enumerate(phases)},
        }), flush=True)


def main(tree, out_dir):
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    walk_rows = instrument(tree, out_dir)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--child", out_dir, walk_rows], timeout=600)
    sys.exit(proc.returncode)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], sys.argv[3] if sys.argv[3:] else "")
    else:
        tree = os.path.abspath(sys.argv[1] if sys.argv[1:] else REPO)
        main(tree, os.path.abspath(sys.argv[2] if sys.argv[2:] else
                                   os.path.join(REPO, "_archive",
                                                "split_bwd")))
