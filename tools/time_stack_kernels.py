"""Time the whole-stack step kernels of one or more copies of the port on
one card, in turns, to compare two versions within one run.

    python tools/time_stack_kernels.py [TREE ...]

Each TREE is a directory that holds a `sound_bubble_tpu_torch/` package
(default: this checkout). In the order given, a child process imports that
package, builds its CUDA kernels (nvcc's register report is printed) and
times `gridnet_stack_step` with CUDA events, 200 launches after 10 warm-up
ones: at the flagship width (`runs/finetune_r5`, 1 m FiLM) and, where the
package has the conv_lstm branch, at the Orange Pi width
(`runs/edge_orangpi_seeded`). The weights come from this checkout's `runs/`.
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
