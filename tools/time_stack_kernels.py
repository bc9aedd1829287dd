"""Time the whole-stack step kernels and the fp32 slab LSTM kernels of one
or more copies of the port on one card, in turns, to compare two versions
within one run.

    python tools/time_stack_kernels.py [TREE ...]

Each TREE is a directory that holds a `sound_bubble_tpu_torch/` package
(default: this checkout). In the order given, a child process imports that
package, builds its CUDA kernels (nvcc's register report is printed) and
times `gridnet_stack_step` with CUDA events, 200 launches after 10 warm-up
ones: at the flagship width (`runs/finetune_r5`, 1 m FiLM) and, where the
package has the conv_lstm branch, at the Orange Pi width
(`runs/edge_orangpi_seeded`); then `lstm_slab_fwd` and `lstm_slab_bwd` in
fp32, 20 launches after one, at the flagship training path's shapes of
chip_smoke.py's phase 6 (intra [145, 1252, 32], inter [313, 580, 32],
H = 64). The weights come from this checkout's `runs/`.
Give each tree twice to see the spread, e.g. parent, change, change,
parent. Prints the card's name and power limit, then one JSON line a run.
Needs one NVIDIA card.
"""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {"flagship": ("finetune_r5", [[0.0, 0.0, 1.0]]),
        "edge": ("edge_orangpi_seeded", None)}
# (T, R, C) of the fp32 slab scans timed
SLAB_SHAPES = {"intra": (145, 1252, 32), "inter": (313, 580, 32)}


def child(tree):
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from sound_bubble_tpu_torch.ops.kernels import _build
    from sound_bubble_tpu_torch.ops.kernels import stack_kernel as sk
    from sound_bubble_tpu_torch.runtime.fast_path import FusedStreamer
    from sound_bubble_tpu_torch.utils import load_pretrained

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    dev = torch.device("cuda")
    _build.load_library()
    log = _build.build_log().splitlines()
    # registers of each kernel, and any helper left as a called function
    out = {"tree": tree,
           "ptxas": [ln.split(":", 1)[1].strip() for ln in log
                     if "Used" in ln or ("Function properties" in ln
                                         and "_kernel" not in ln)]}
    for name, (run, dis) in RUNS.items():
        if name == "edge" and not hasattr(sk, "lstm_down"):
            continue
        net = load_pretrained(os.path.join(REPO, "runs", run), device=dev)
        fs = FusedStreamer(net, dis_embed=dis, device=dev)
        cfg = net.cfg
        rng = np.random.default_rng(0)

        def draw(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32)).to(dev)

        F, D, H, B = cfg.n_freqs, cfg.D, cfg.H, cfg.B
        x, h0, c0 = draw(F, D), draw(B, F, H) * 0.5, draw(B, F, H) * 0.5
        fw, fb = fs.film if fs.film is not None else (None, None)
        with torch.no_grad():
            for _ in range(10):
                sk.gridnet_stack_step(fs.packed, x, h0, c0, fw, fb,
                                      eps=cfg.eps)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(200):
                sk.gridnet_stack_step(fs.packed, x, h0, c0, fw, fb,
                                      eps=cfg.eps)
            end.record()
            torch.cuda.synchronize()
        out[f"{name}_ms"] = start.elapsed_time(end) / 200

    from sound_bubble_tpu_torch.ops.kernels import lstm_slab as ls
    for name, (t_len, r, c) in SLAB_SHAPES.items():
        rng = np.random.default_rng(0)

        def draw(*shape, scale=1.0):
            return torch.from_numpy((rng.standard_normal(shape) * scale)
                                    .astype(np.float32)).to(dev)

        h = 64
        w = (draw(c, 4 * h, scale=h ** -0.5), draw(h, 4 * h, scale=h ** -0.5),
             draw(4 * h, scale=h ** -0.5))
        x, h0, c0 = draw(t_len, r, c), draw(r, h) * 0.5, draw(r, h) * 0.5
        with torch.no_grad():
            ys, _, _, ck = ls.lstm_slab_fwd(*w, x, h0, c0, False)
            bargs = (*w, x, ls.shift_prev(ys, h0, False), ck,
                     draw(t_len, r, h), draw(r, h), draw(r, h), False)
            for kind, fn in (("fwd", lambda: ls.lstm_slab_fwd(
                    *w, x, h0, c0, False)),
                    ("bwd", lambda: ls.lstm_slab_bwd(*bargs))):
                fn()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    fn()
                end.record()
                torch.cuda.synchronize()
                out[f"slab_{name}_{kind}_ms"] = start.elapsed_time(end) / 20
    print(json.dumps(out), flush=True)


def main(trees):
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    for tree in trees or [REPO]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", tree], capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            sys.exit(f"{tree}: {proc.stderr[-3000:]}")
        print(proc.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
    else:
        main(sys.argv[1:])
