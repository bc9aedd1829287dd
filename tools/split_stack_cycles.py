"""Split one call of rows 1-4 (`stack_walk_kernel`, the cluster kernel of
`sound_bubble_tpu_torch/csrc/stack_walk.cu`) by phase, for each of the
cluster's eight blocks, on one card.

    python tools/split_stack_cycles.py [OUT_DIR]

Copies this checkout's `sound_bubble_tpu_torch/` into OUT_DIR (default
`_archive/split_stack`, listed in .gitignore), stamps `clock64()` at thread
0's phase boundaries in the copy's `stack_walk.cu` (into a `__device__`
array read back through an extra C entry point), builds the copy and runs
`gridnet_stack_step` and `gridnet_stack_step_attn` at the flagship's widths
(rows 1 and 3: F = 145, D = 32, H = 64, B = 6) and on a conv_lstm pack at
the Orange Pi's (rows 2 and 4: D = 24, B = 3, s = 5; attention L = 4, E =
2, W = 100), seeded nets, with FiLM. Prints the card's name and power
limit, then one JSON line: for
each kernel its ms a call (CUDA events, 20 calls, the stamped copy) and,
for each block of the cluster, the cycles of one call by phase, summed
over the GridNet blocks (a phase ends at the stamp after it; a block's
wait at a cluster barrier falls in the phase that ends there). The string
edits raise if the source moved under them. Needs one NVIDIA card.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (text of stack_walk.cu, stamp before or after it, the phase it ends)
ANCHORS = (
    ("  cluster_sync();  // block 0's z is in\n", "after", "prologue"),
    ("    if (kAttn && cta >= 2) stage_attn(a, b, n, f0, st);\n", "after",
     "stage"),
    ("    sbt_fwd32::cp_async_wait_all();\n    cluster_sync();", "before",
     "walk (blocks 2-7: hr, then idle)"),
    ("  // y, block b's hr and the staged data are in\n", "after",
     "wait + barrier"),
    ("      rows_matmul<1>(ys, H2, nq, st.wp, H2, sD", "before", "y, hr in"),
    ("      ln_rows(xs, zs, n, D, st.tln, st.tln + D, a.eps);\n", "before",
     "proj / up conv"),
    ("      const size_t sb = ((size_t)b * F + f0) * H;\n", "before",
     "LayerNorm + gates"),
    ("      rows_matmul<1>(hs, H, n, st.wp2, H, D", "before", "cell"),
    ("    // ---- local causal attention over the W ring slots", "before",
     "proj2"),
    ("      // 2. normalise; the ring slot pos; the partial scores\n",
     "before", "attn 1: q, k, v, moments + barrier"),
    ("      constexpr int kPs = 2;\n", "before", "attn 2: normalise, ring"),
    ("      // 3. the scores, the softmax, the weighted values", "before",
     "attn 2: partial scores + barrier"),
    ("      constexpr int kIt = 3;\n", "before", "attn 3: scores, softmax"),
    ("      rows_matmul<1>(os, D, n, st.wo", "before",
     "attn 3: weighted values"),
    ("      // 4. the LayerNorm over the [F, D] frame, the residual\n",
     "before", "attn 3: out proj, moments + barrier"),
    ("    // ---- the next block's FiLM and intra head: the walk's input\n",
     "before", "attn 4: LayerNorm, residual"),
    ("      cluster_sync();  // z is in; the staged data is free again\n",
     "after", "FiLM, head (LayerNorm / down conv) + barrier"),
    ("  for (int i = tid; i < n * D; i += nt) a.x_out[f0 * D + i] = xs[i];\n",
     "after", "x out"),
)
STAMP = ("  int k_ = 0;\n#define STAMP(i) do { if (threadIdx.x == 0 && "
         "k_ < 254) { g_stamp[blockIdx.x][k_++] = (i); "
         "g_stamp[blockIdx.x][k_++] = clock64(); } } while (0)\n"
         "  STAMP(-1);\n")


def instrument(out_dir):
    """The stamped copy of the package in out_dir."""
    if os.path.exists(out_dir):
        shutil.rmtree(out_dir)
    shutil.copytree(os.path.join(REPO, "sound_bubble_tpu_torch"),
                    os.path.join(out_dir, "sound_bubble_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(out_dir, "sound_bubble_tpu_torch", "csrc",
                        "stack_walk.cu")
    with open(path) as fh:
        s = fh.read()
    edits = [("namespace {\n\nconstexpr int kCTAs",
              "__device__ long long g_stamp[8][256];\nnamespace {\n\n"
              "constexpr int kCTAs"),
             ("  const int pstride = 2 * (3 * L + 1);  // floats of a "
              "block's partials\n",
              "  const int pstride = 2 * (3 * L + 1);  // floats of a "
              "block's partials\n" + STAMP)]
    edits += [(text, text + f"STAMP({i});\n" if where == "after"
               else f"STAMP({i});\n" + text)
              for i, (text, where, _) in enumerate(ANCHORS)]
    for old, new in edits:
        if s.count(old) != 1:
            raise RuntimeError(f"stack_walk.cu: {old[:60]!r} found "
                               f"{s.count(old)} times")
        s = s.replace(old, new)
    s += ('\nextern "C" int sbt_stamps(long long* out) {\n'
          '  return (int)cudaMemcpyFromSymbol(out, g_stamp, '
          'sizeof(g_stamp));\n}\n'
          'extern "C" int sbt_stamps_clear(const long long* zeros) {\n'
          '  return (int)cudaMemcpyToSymbol(g_stamp, zeros, '
          'sizeof(g_stamp));\n}\n')
    with open(path, "w") as fh:
        fh.write(s)


def split(stamps):
    """{phase: cycles} of one block's (index, clock) records."""
    recs = stamps.reshape(-1, 2)
    recs = recs[:int((recs[:, 1] != 0).sum())]
    out = {}
    for (_, t0), (i, t1) in zip(recs[:-1], recs[1:]):
        name = ANCHORS[i][2]
        out[name] = out.get(name, 0) + int(t1 - t0)
    out["total"] = int(recs[-1, 1] - recs[0, 1])
    return out


def child(out_dir):
    sys.path.insert(0, out_dir)
    import numpy as np
    import torch

    from sound_bubble_tpu_torch.models.tfgridnet.model import Net, NetConfig
    from sound_bubble_tpu_torch.ops.kernels import _build
    from sound_bubble_tpu_torch.ops.kernels import stack_kernel as sk
    from sound_bubble_tpu_torch.weights import param_tree

    if not sk.__file__.startswith(out_dir):
        raise RuntimeError(f"imported {sk.__file__}, not the stamped copy")
    dev = torch.device("cuda")
    lib = _build.load_library()
    lib.sbt_stamps.argtypes = [ctypes.c_void_p]
    lib.sbt_stamps_clear.argtypes = [ctypes.c_void_p]
    res = {}
    for row, attn, widths in (
            (1, False, dict(D=32, B=6, conv_lstm=False)),
            (3, True, dict(D=32, B=6, conv_lstm=False)),
            (2, False, dict(D=24, B=3, conv_lstm=True, lstm_down=5)),
            (4, True, dict(D=24, B=3, conv_lstm=True, lstm_down=5))):
        cfg = NetConfig(use_attn=attn, stft_chunk_size=192, stft_pad_size=96,
                        H=64, **widths)
        rng = np.random.default_rng(0)
        tree = param_tree(Net(cfg).init_weights(
            torch.Generator().manual_seed(0)))
        packed = {k: v.to(dev) for k, v in sk.pack_stack_params(
            cfg, tree).items()}
        F, D, H, B, W = cfg.n_freqs, cfg.D, cfg.H, cfg.B, cfg.local_atten_len

        def draw(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32)).to(dev)

        x, h0, c0 = draw(F, D), draw(B, F, H) * 0.5, draw(B, F, H) * 0.5
        fw, fb = draw(B - 1, F, D), draw(B - 1, F, D)
        if attn:
            pa = {k: v.to(dev) for k, v in sk.pack_attn_params(
                cfg, tree).items()}
            kr, vr = draw(B, cfg.L * cfg.E, W, F), draw(B, D, W, F)

            pos = torch.tensor([3], dtype=torch.int32, device=dev)

            def call():
                sk.gridnet_stack_step_attn(packed, pa, x, h0, c0, kr, vr,
                                           pos, cfg.L, fw, fb, eps=cfg.eps,
                                           checked=True)
        else:
            def call():
                sk.gridnet_stack_step(packed, x, h0, c0, fw, fb, eps=cfg.eps,
                                      checked=True)
        # the stamps of the last call; none left of another row's, which
        # may have more of them
        sk.check_packed(packed, dev, *((pa, cfg.L) if attn else ()))
        stamps = np.zeros((8, 256), np.int64)
        torch.cuda.synchronize()
        if lib.sbt_stamps_clear(stamps.ctypes.data):
            raise RuntimeError("cudaMemcpyToSymbol failed")
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        if lib.sbt_stamps(stamps.ctypes.data):
            raise RuntimeError("cudaMemcpyFromSymbol failed")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            call()
        end.record()
        torch.cuda.synchronize()
        res[f"row{row}"] = {
            "ms": start.elapsed_time(end) / 20,
            "cycles": {c: split(stamps[c]) for c in range(8)}}
    print(json.dumps(res), flush=True)


def main(out_dir):
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    instrument(out_dir)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--child", out_dir], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        sys.exit(proc.stderr[-3000:])
    print(proc.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
    else:
        main(os.path.abspath(sys.argv[1]) if sys.argv[1:] else
             os.path.join(REPO, "_archive", "split_stack"))
