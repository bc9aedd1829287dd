"""Time the whole-stack step kernels and the LSTM training scans of one or
more copies of the port on one card, in turns, to compare two versions
within one run.

    python tools/time_stack_kernels.py [TREE ...]

Each TREE is a directory that holds a `sound_bubble_tpu_torch/` package
(default: this checkout). In the order given, a child process imports that
package, builds its CUDA kernels (nvcc's register report is printed) and
times `gridnet_stack_step` with CUDA events, 200 launches after 10 warm-up
ones, and as 20 calls captured in one CUDA graph (`*_graph_ms`): at the
flagship width (`runs/finetune_r5`, 1 m FiLM) and, where the package has
the conv_lstm branch, at the Orange Pi width (`runs/edge_orangpi_seeded`);
`gridnet_stack_step_attn` the same way at the attention nets' widths
(`runs/attn_flagship_seeded`: row 3; `runs/attn_orangpi_seeded`: row 4),
pos advancing a call; `FusedStreamer.feed` of each of these four nets, ms
a chunk on the host clock (chip_smoke.py's `feed_ms`, 100 chunks) and as
20 chunks captured in one CUDA graph (None where the capture fails); the
worst max-abs error of rows 1-4 against their plain versions over chained
steps (`*_chain_err`: rows 1 and 2 at the flagship's and the Orange Pi's
widths, 5 steps; rows 3 and 4 at the attention nets', W + 5 = 105 steps,
the case of tests/test_torch_port_cuda.py's attention test); then
`lstm_slab_fwd` and `lstm_slab_bwd`, 20 launches after one, in fp32 at the
flagship training path's shapes of chip_smoke.py's phase 6
(intra [145, 1252, 32], inter [313, 580, 32], H = 64) and in the mixed mode
(bf16 x and weights, as the campaign trainer runs them) at the bf16 recipe's
batch-8 shapes of phase 13 (intra [145, 2504, 32], inter [313, 1160, 32]);
and, for each of these four shapes, `torch.profiler`'s split of one
`lstm_slab_bwd` call among the kernels it launches (device us by kernel
name); then the seq route's walks, 20 launches after one: the
single-direction `lstm_seq_fwd` (row 6) and its backward `lstm_seq_bwd`
(row 7) in fp32 at the inter LSTM's shape of phase 20 ([313, 580, 32]) and
mixed at the recipe's batch 8 ([313, 1160, 32]), the fused-direction
`blstm_seq_fwd` (row 8) and its backward `blstm_seq_bwd` (row 9) in fp32
at the intra BLSTM's ([145, 1252, 32]) and mixed at batch 8
([145, 2504, 32]), each forward beside cuDNN's LSTM forward
(`torch.nn.LSTM`) on the same x, each backward (`*_bwd_ms`) on its
forward's gates and c (row 7 from drawn (dhT, dcT), and, where the tree's
row 7 is the backward walk, again at the other row tile that keeps one
wave: `*_rows8_bwd_ms` fp32 and (bf16, fp32), `*_rows16_bwd_ms` (bf16,
bf16), against 5 and 9 rows a block); the mixed walks at batch 8 again
with fp32 weights (`*_fp32w_fwd_ms`, `*_fp32w_bwd_ms`: the (bf16, fp32)
pair of `train_pt --bf16`) and, where the tree's walk has a mixed mode,
row 8b on the two-wave grid of 19 rows a block
(`seq_mixed_intra_rows19_fwd_ms`) beside its one-wave 38; then the
whole of the fused inference BLSTM `blstm_infer` (row 5), 200 calls after
10, at chip_smoke.py's four ROW5_SHAPES, beside cuDNN's bidirectional LSTM
with the same weights, and both again as 20 calls captured in one CUDA
graph (`*_graph_ms`: the device's time, no host time between calls); and
`ModelWrapper.feed` of the flagship with every intra BLSTM on row 5: its
device operations a chunk (torch.profiler) and ms a chunk (host clock,
100 chunks), with chip_smoke.py's helpers; last, the seq route's fp32 and
bf16 recipe train steps as phase 24 times them (`seq_step_*`).
The weights come from this checkout's `runs/` and, for the LSTMs, from
seed 0.
Give each tree twice to see the spread, e.g. parent, change, change,
parent. Prints the card's name and power limit, then one JSON line a run.
Needs one NVIDIA card.
"""
import inspect
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {"flagship": ("finetune_r5", [[0.0, 0.0, 1.0]]),
        "edge": ("edge_orangpi_seeded", None)}
# the attention nets (rows 3 and 4), with the 1 m embedding
ATTN_RUNS = {"attn_flagship": "attn_flagship_seeded",
             "attn_orangpi": "attn_orangpi_seeded"}
# (T, R, C, mixed) of the slab scans timed
SLAB_SHAPES = {"intra": (145, 1252, 32, False), "inter": (313, 580, 32, False),
               "mixed_intra": (145, 2504, 32, True),
               "mixed_inter": (313, 1160, 32, True)}
# (T, R, C, mixed, directions) of the seq route's forwards timed
SEQ_SHAPES = {"inter": (313, 580, 32, False, 1),
              "mixed_inter": (313, 1160, 32, True, 1),
              "intra": (145, 1252, 32, False, 2),
              "mixed_intra": (145, 2504, 32, True, 2)}
# (name, R, T, C) of row 5, as chip_smoke.py's ROW5_SHAPES
ROW5_SHAPES = (("serve1", 1, 145, 32), ("serve4", 4, 145, 32),
               ("conv1", 1, 29, 24), ("offline", 250, 145, 32))


def profile_split(fn, calls=5):
    """Mean device us of a launch, by kernel, from torch.profiler's CUDA
    activity over `calls` calls of fn() (CUPTI sees the kernels the ctypes
    library launches; the slab backward launches each of its kernels once a
    call). A mean over the launches the trace holds: now and then it drops
    a kernel's record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us > 0 and ev.count:
            name = ev.key.replace("(anonymous namespace)::", "") \
                .replace("void ", "").split("(")[0]
            split[name] = round(float(us) / ev.count, 3)
    return split


def scan_operands(t_len, r, c, mixed, dev, h=64):
    """(draw, w_ih, w_hh, b, x, h0, c0) of one LSTM scan from seed 0 (bf16
    x and weights when mixed); draw(*shape, dtype=...) gives more."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    adt = torch.bfloat16 if mixed else torch.float32

    def draw(*shape, scale=1.0, dtype=torch.float32):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(dev, dtype)

    return (draw, draw(c, 4 * h, scale=h ** -0.5, dtype=adt),
            draw(h, 4 * h, scale=h ** -0.5, dtype=adt),
            draw(4 * h, scale=h ** -0.5, dtype=adt),
            draw(t_len, r, c, dtype=adt), draw(r, h) * 0.5,
            draw(r, h) * 0.5)


def events_ms(fn, n):
    """ms a call of fn(), CUDA events over n calls."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n):
    """ms a call of fn() with no host time between calls: n calls captured
    in one CUDA graph, replayed 10 times (CUDA events); None where the
    capture fails."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    try:
        with torch.no_grad():
            with torch.cuda.stream(side):
                for _ in range(3):
                    fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(n):
                    fn()
    except RuntimeError:
        return None
    graph.replay()
    return events_ms(graph.replay, 10) / n


def cudnn_lstm(c, h, nd, dtype, dev, weights=None):
    """torch.nn.LSTM (cuDNN) of nd directions, the yardstick; weights: the
    port's {fwd, bwd} params to copy in (else its own init)."""
    import torch

    lstm = torch.nn.LSTM(c, h, batch_first=weights is not None,
                         bidirectional=nd == 2).to(dev, dtype)
    if weights is not None:
        with torch.no_grad():
            for sfx, d in (("", "fwd"), ("_reverse", "bwd")):
                p = weights[d]
                getattr(lstm, f"weight_ih_l0{sfx}").copy_(p["w_ih"].T)
                getattr(lstm, f"weight_hh_l0{sfx}").copy_(p["w_hh"].T)
                getattr(lstm, f"bias_ih_l0{sfx}").copy_(p["b"])
                getattr(lstm, f"bias_hh_l0{sfx}").zero_()
    return lstm


def build_seconds(log):
    """{source or "link": seconds} from a build log (`_build.build_log()`:
    each command's line, its output, then its seconds in brackets)."""
    secs = {}
    for part in log.split("$ ")[1:]:
        cmd = part.split("\n", 1)[0].split()
        name = os.path.basename(cmd[-1]) if "-c" in cmd else "link"
        for ln in part.splitlines():
            if re.fullmatch(r"\[[0-9.]+ s\]", ln):
                secs[name] = float(ln[1:-3])
    return secs


def child(tree):
    sys.path.insert(0, REPO)          # chip_smoke.py's helpers
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from sound_bubble_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    log = _build.build_log().splitlines()
    # registers of each kernel, and any helper left as a called function;
    # the build's seconds by source
    out = {"tree": tree,
           "ptxas": [ln.split(":", 1)[1].strip() for ln in log
                     if "Used" in ln or ("Function properties" in ln
                                         and "_kernel" not in ln)],
           "build_s": build_seconds(_build.build_log())}
    time_stack_steps(out, dev)
    chain_errors(out, dev)

    from sound_bubble_tpu_torch.ops.kernels import lstm_slab as ls
    for name, (t_len, r, c, mixed) in SLAB_SHAPES.items():
        draw, *w, x, h0, c0 = scan_operands(t_len, r, c, mixed, dev)
        adt, h = x.dtype, 64
        with torch.no_grad():
            ys, _, _, ck = ls.lstm_slab_fwd(*w, x, h0, c0, False)
            bargs = (*w, x, ls.shift_prev(ys, h0, False, adt), ck,
                     draw(t_len, r, h, dtype=adt), draw(r, h), draw(r, h),
                     False)
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
            out[f"slab_{name}_bwd_split_us"] = profile_split(
                lambda: ls.lstm_slab_bwd(*bargs))

    time_forwards(out, dev)
    time_seq_steps(out, dev)
    print(json.dumps(out), flush=True)


def time_seq_steps(out, dev):
    """ms per train step and peak GB on the seq route, chip_smoke.py phase
    24's two steps: the fp32 step (`PLModule.train_step`, batch 4 x 2.5 s)
    and the bf16 recipe's (`train_stream.train_step`, batch 8), each from
    the flagship checkpoint, host clock, 5 steps after one (`seq_step_*`),
    into out."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from sound_bubble_tpu_torch import train_stream
    from sound_bubble_tpu_torch.data.synth import golden_batch
    from sound_bubble_tpu_torch.train.module import PLModule

    with open(cs.TRAIN_CONFIG) as fh:
        args = {**json.load(fh)["pl_module_args"], "lstm_scan": "seq"}
    flagship = os.path.join(cs.RUN_DIR, "checkpoints", "best.pt")
    mod = PLModule(**{**args, "init_ckpt": flagship}, device=dev)
    out["seq_step_fp32_ms"], out["seq_step_fp32_gb"] = cs.train_step_ms(
        mod, golden_batch(cs.SEED), dev)
    del mod
    b0, b1 = golden_batch(cs.SEED), golden_batch(cs.SEED + 1)
    mod = cs.bf16_module(args, flagship, dev)
    model_in = mod._model_inputs({k: np.concatenate([b0[0][k], b1[0][k]])
                                  for k in ("mixture", "dis_embed")})
    gt = torch.from_numpy(np.concatenate([b0[1]["target"],
                                          b1[1]["target"]])).to(dev)
    train_stream.train_step(mod, model_in, gt, True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(5):
        train_stream.train_step(mod, model_in, gt, True)
    torch.cuda.synchronize()
    out["seq_step_bf16_ms"] = (time.perf_counter() - t) / 5 * 1e3
    out["seq_step_bf16_gb"] = torch.cuda.max_memory_allocated() / 1e9


def time_stack_steps(out, dev):
    """The stack steps (rows 1-4) and FusedStreamer.feed, into out."""
    import numpy as np
    import torch

    from chip_smoke import feed_ms
    from sound_bubble_tpu_torch.ops.kernels import stack_kernel as sk
    from sound_bubble_tpu_torch.runtime.fast_path import FusedStreamer
    from sound_bubble_tpu_torch.utils import load_pretrained

    runs = dict(RUNS, **{k: (v, [[0.0, 0.0, 1.0]])
                         for k, v in ATTN_RUNS.items()})
    for name, (run, dis) in runs.items():
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
        if cfg.use_attn:
            W, pos = cfg.local_atten_len, [0]
            kr, vr = draw(B, cfg.L * cfg.E, W, F), draw(B, D, W, F)

            def step():
                sk.gridnet_stack_step_attn(
                    fs.packed, fs.packed_attn, x, h0, c0, kr, vr, pos[0],
                    cfg.L, fw, fb, eps=cfg.eps, checked=True)
                pos[0] = (pos[0] + 1) % W
        else:
            def step():
                sk.gridnet_stack_step(fs.packed, x, h0, c0, fw, fb,
                                      eps=cfg.eps, checked=True)
        with torch.no_grad():
            for _ in range(10):
                step()
            out[f"{name}_ms"] = events_ms(step, 200)
        out[f"{name}_graph_ms"] = graph_ms(step, 20)
        out[f"{name}_feed_ms"] = feed_ms(fs, 100, rng)
        win = draw(1, cfg.num_ch, cfg.n_fft)
        fs.reset()
        out[f"{name}_feed_graph_ms"] = graph_ms(lambda: fs.feed(win), 20)


def chain_errors(out, dev):
    """The worst max-abs error of x, h0, c0 (and the rings) against the
    plain versions over chained steps (x new a step, the state carried),
    into out: rows 1 and 2 at the flagship's and the Orange Pi's widths
    over 5 steps, rows 3 and 4 at the attention nets' over W + 5 steps from
    zero rings (pos wraps); the weights as tests/test_torch_port_cuda.py's
    attention case draws them (the model's initial weights moved by 0.05
    N(0, 1)), with FiLM."""
    import numpy as np
    import torch

    from sound_bubble_tpu_torch.models.tfgridnet.model import Net, NetConfig
    from sound_bubble_tpu_torch.ops.kernels import stack_kernel as sk
    from sound_bubble_tpu_torch.weights import param_tree

    flagship = dict(D=32, B=6, conv_lstm=False)
    orangepi = dict(D=24, B=3, conv_lstm=True, lstm_down=5)
    for name, attn, widths in (("row1", False, flagship),
                               ("row3", True, flagship),
                               ("row2", False, orangepi),
                               ("row4", True, orangepi)):
        cfg = NetConfig(use_attn=attn, stft_chunk_size=192, stft_pad_size=96,
                        H=64, **widths)
        rng = np.random.default_rng(0)
        net = Net(cfg).init_weights(torch.Generator().manual_seed(0))
        with torch.no_grad():
            for p in net.parameters():
                p.add_(torch.from_numpy(np.asarray(rng.standard_normal(
                    tuple(p.shape)) * 0.05, np.float32)))
        tree = param_tree(net)
        packed = {k: v.to(dev) for k, v in sk.pack_stack_params(
            cfg, tree).items()}
        F, D, H, B, W = cfg.n_freqs, cfg.D, cfg.H, cfg.B, cfg.local_atten_len

        def draw(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32)).to(dev)

        fw, fb = draw(B - 1, F, D), draw(B - 1, F, D)
        got = [draw(B, F, H) * 0.5, draw(B, F, H) * 0.5]
        if attn:
            pa = {k: v.to(dev) for k, v in sk.pack_attn_params(
                cfg, tree).items()}
            got += [torch.zeros((B, cfg.L * cfg.E, W, F), device=dev),
                    torch.zeros((B, D, W, F), device=dev)]
        want = [t.clone() for t in got]
        err = []
        with torch.no_grad():
            for step in range(W + 5 if attn else 5):
                x = draw(F, D)
                if attn:
                    xk, *got = sk.gridnet_stack_step_attn(
                        packed, pa, x, *got, step % W, cfg.L, fw, fb,
                        eps=cfg.eps)
                    xr, *want = sk.gridnet_stack_step_attn_ref(
                        packed, pa, x, *want, step % W, cfg.L, fw, fb,
                        eps=cfg.eps)
                else:
                    xk, *got = sk.gridnet_stack_step(packed, x, *got, fw, fb,
                                                     eps=cfg.eps)
                    xr, *want = sk.gridnet_stack_step_ref(
                        packed, x, *want, fw, fb, eps=cfg.eps)
                err.append([float((a - b).abs().max())
                            for a, b in zip([xk, *got], [xr, *want])])
        out[f"{name}_chain_err"] = [max(col) for col in zip(*err)]


def time_forwards(out, dev):
    """The seq route's forwards and row 5's whole function, each beside
    cuDNN's LSTM, into out."""
    import numpy as np
    import torch

    from sound_bubble_tpu_torch.ops.kernels import lstm_slab as ls
    from sound_bubble_tpu_torch.ops.kernels import lstm_train_kernel as lk
    t_len, r, c, _ = SLAB_SHAPES["mixed_intra"]
    _, *w, x, h0, c0 = scan_operands(t_len, r, c, True, dev)
    w = [a.float() for a in w]
    with torch.no_grad():
        ls.lstm_slab_fwd(*w, x, h0, c0, False)
        out["slab_mixed_intra_fp32w_fwd_ms"] = events_ms(
            lambda: ls.lstm_slab_fwd(*w, x, h0, c0, False), 20)
    for name, (t_len, r, c, mixed, nd) in SEQ_SHAPES.items():
        draw, *w, x, h0, c0 = scan_operands(t_len, r, c, mixed, dev)
        if nd == 1:
            fn, fargs = lk.lstm_seq_fwd, (*w, x, h0, c0)
        else:
            wb = [draw(*t.shape, scale=64 ** -0.5, dtype=t.dtype) for t in w]
            fn = lk.blstm_seq_fwd
            fargs = (*lk._blstm_pack(
                dict(zip(("w_ih", "w_hh", "b"), w)),
                dict(zip(("w_ih", "w_hh", "b"), wb))), x)
        lstm = cudnn_lstm(c, 64, nd, x.dtype, dev)
        dy = draw(t_len, r, nd * 64, dtype=x.dtype)

        dhT, dcT = draw(r, 64), draw(r, 64)     # row 7's entering states

        def bwd(args):
            """The row's backward walk (7 or 9) on the forward's gates and
            c for args (row 7: from (dhT, dcT), c0 the forward's)."""
            _, gates, c_seq = fn(*args)
            w_hh = args[1] if nd == 1 else args[2]
            if nd == 1:
                return lambda: lk.lstm_seq_bwd(gates, c_seq, c0, dy, dhT,
                                               dcT, w_hh, x.dtype)
            return lambda: lk.blstm_seq_bwd(w_hh, gates, c_seq, dy, x.dtype)

        def rows_bwd_ms(args, rows):
            """ms of row 7's walk at `rows` rows a block, where the tree's
            row 7 is the walk (its grid picked by seq_bwd_row_tiles with a
            direction count); else None."""
            pick = lk.seq_bwd_row_tiles
            if "nd" not in inspect.signature(pick).parameters:
                return None
            lk.seq_bwd_row_tiles = lambda r_, h_, code=0, n_sm=132, nd=2: (
                (rows, -(-r_ // rows)) if nd == 1 else
                pick(r_, h_, code, n_sm, nd))
            try:
                step = bwd(args)
                step()
                return events_ms(step, 20)
            finally:
                lk.seq_bwd_row_tiles = pick

        with torch.no_grad():
            fn(*fargs)
            out[f"seq_{name}_fwd_ms"] = events_ms(lambda: fn(*fargs), 20)
            lstm(x)
            out[f"seq_{name}_cudnn_fwd_ms"] = events_ms(lambda: lstm(x), 20)
            step = bwd(fargs)
            step()
            out[f"seq_{name}_bwd_ms"] = events_ms(step, 20)
            if nd == 1:    # row 7 at the other tile: 8 rows, 16 mixed
                alt = 16 if mixed else 8
                out[f"seq_{name}_rows{alt}_bwd_ms"] = rows_bwd_ms(fargs, alt)
            if mixed:
                wargs = [a.float() if a is not x else a for a in fargs]
                fn(*wargs)
                out[f"seq_{name}_fp32w_fwd_ms"] = events_ms(
                    lambda: fn(*wargs), 20)
                step = bwd(wargs)
                step()
                out[f"seq_{name}_fp32w_bwd_ms"] = events_ms(step, 20)
                if nd == 1:
                    out[f"seq_{name}_fp32w_rows8_bwd_ms"] = rows_bwd_ms(
                        wargs, 8)
            if mixed and nd == 2 and hasattr(ls, "FWD_ROWS_MAX_MIXED"):
                cap = ls.FWD_ROWS_MAX_MIXED
                ls.FWD_ROWS_MAX_MIXED = 19
                try:
                    fn(*fargs)
                    out[f"seq_{name}_rows19_fwd_ms"] = events_ms(
                        lambda: fn(*fargs), 20)
                finally:
                    ls.FWD_ROWS_MAX_MIXED = cap

    from sound_bubble_tpu_torch.ops.kernels import lstm_kernel as rk
    rng = np.random.default_rng(0)
    for name, r, t_len, c in ROW5_SHAPES:
        def u(*shape):
            return torch.from_numpy(rng.uniform(-0.125, 0.125, shape)
                                    .astype(np.float32)).to(dev)
        params = {d: {"w_ih": u(c, 256), "w_hh": u(64, 256), "b": u(256)}
                  for d in ("fwd", "bwd")}
        x = torch.from_numpy(rng.standard_normal((r, t_len, c))
                             .astype(np.float32)).to(dev)
        lstm = cudnn_lstm(c, 64, 2, torch.float32, dev, params)
        with torch.no_grad():
            for _ in range(10):
                rk.blstm_infer(params, x)
            out[f"row5_{name}_ms"] = events_ms(
                lambda: rk.blstm_infer(params, x), 200)
            lstm(x)
            out[f"row5_{name}_cudnn_ms"] = events_ms(lambda: lstm(x), 200)
        out[f"row5_{name}_graph_ms"] = graph_ms(
            lambda: rk.blstm_infer(params, x), 20)
        out[f"row5_{name}_cudnn_graph_ms"] = graph_ms(lambda: lstm(x), 20)

    from chip_smoke import feed_ops, wrapper_chunk_ms
    from sound_bubble_tpu_torch import utils
    from sound_bubble_tpu_torch.runtime.streaming import ModelWrapper
    wrapper = ModelWrapper(utils.load_torch_pretrained(
        os.path.join(REPO, "runs", RUNS["flagship"][0]), device=dev,
        pallas_blstm=True).model, device=dev)
    with torch.no_grad():
        out["row5_feed_ops"] = feed_ops(wrapper, 10, rng)
        out["row5_feed_ms"] = wrapper_chunk_ms(wrapper, 100, rng)


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
