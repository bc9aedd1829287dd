"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's serving and training paths (`sound_bubble_tpu_torch`) at
the full width of the flagship TF-GridNet (`runs/finetune_r5`: F=145, D=32,
B=6, H=64, phases 3-8, and its bf16 recipe, phases 13-15) and of the edge
model (`real_experiments/orangpi_model_*.json`: conv_lstm, unconditioned,
F=145, D=24, B=3, H=64, lstm_down=5, phases 9-12):

1. device: the card's name and power limit, torch and CUDA versions;
2. build: the CUDA kernels, with nvcc's -Xptxas -v report, compiled anew
   whatever library is there (`load_library(rebuild=True)`); the later
   processes of the run (phase 27's CLIs among them) load that library
   without building, as its key matches;
3. kernel vs plain: `gridnet_stack_step` (row 1: `stack_walk_kernel<64,
   false, false>`, one cluster of 8 blocks a call) against
   `gridnet_stack_step_ref`
   on the card, 5 chained steps with the flagship's packed weights and
   FiLM;
4. serving: the 9 goldens of `test_samples/` streamed chunk by chunk through
   `FusedStreamer` (its `feed` replays one captured CUDA graph of the step
   a chunk, as in phases 10 and 17); SI-SDRi and decay per sample held against the JAX
   package's fp32 numbers on the same audio
   (`runs/goldens_test_samples_jax.json`), per-radius means printed, and
   `runs/goldens_baseline.json` (the reference's own golden set, other
   audio) printed once for information; then the kernel path held against
   the plain `ModelWrapper` path;
5. times of the kernel (CUDA events, and 20 calls in one CUDA graph: the
   device's time), its plain version and one 8 ms chunk;
6. slab kernels vs plain: the CUDA LSTM scans `lstm_slab_fwd` /
   `lstm_slab_bwd` against their plain versions at the flagship training
   path's shapes (intra [145, 1252, 32] both directions, inter
   [313, 580, 32]), the edge training path's (intra [29, 1252, 24] both
   directions, inter [313, 580, 24]; the Raspberry Pi intra
   [29, 1252, 16]) and a ragged one ([13, 37, 32]); the fp32 forward's
   rows a block and blocks logged (`lstm_slab.fwd_row_tiles`); the
   backward launched twice on the same inputs, bit-equal;
7. training: seeded sample dirs, then `sound_bubble_tpu_torch.train_pt` on
   `syn_experiments/pretrain_stage.json` (dataset paths, epochs and
   num_workers changed) for 2 epochs and a resumed third; the slab launches
   per step; one train step on the kernel path against the plain path; one
   step from the flagship checkpoint against the JAX package's numbers
   (`runs/train_step_golden_jax.json`);
8. times of the slab kernels, their plain versions, cuDNN's LSTM as the
   library yardstick, `torch.profiler`'s split of one backward call among
   its kernels, and ms per train step;
9. conv kernel vs plain: `gridnet_stack_step` on conv_lstm packs (row 2:
   `stack_walk_kernel<64, false, true>`, one cluster of 8 blocks a call;
   H = 8 at the ragged F) against `gridnet_stack_step_ref`, 5
   chained steps, at the Orange Pi width with the committed seeded weights
   (`runs/edge_orangpi_seeded`), the Raspberry Pi width (D=16) with seeded
   weights, and a ragged F (25 rows, lstm_down 4, with FiLM);
10. edge serving: the 9 goldens of `test_samples/` through `FusedStreamer` on
   `runs/edge_orangpi_seeded`, through the serving CLI's `evaluate_dir`,
   per sample against the JAX package's numbers for the same weights
   (`runs/goldens_edge_jax.json`, `tools/jax_goldens_edge.py`), and the first
   20 chunks of `syn_1m/00002` against the JAX output there; then the kernel
   path against the plain `ModelWrapper` path;
11. edge training: `train_pt` on the Orange Pi pretrain config, then on the
   finetune config warm-started from its `last.pt` (dataset paths, epochs,
   num_workers and init_ckpt changed), the slab launches per step; one
   finetune step from the seeded weights on the kernel path against the
   plain path and against the JAX package's numbers
   (`runs/train_step_golden_edge_jax.json`);
12. times of the conv kernel (CUDA events, and 20 calls in one CUDA
   graph), its plain version, one edge 8 ms chunk, one edge train step and
   the slab kernels at the edge step's shapes;
13. mixed slab kernels vs plain: the bf16 instantiation of `lstm_slab_fwd` /
   `lstm_slab_bwd` against their plain versions at the flagship recipe's
   shapes (batch 8 x 2.5 s: intra [145, 2504, 32] both directions, inter
   [313, 1160, 32]), the edge's (intra [29, 2504, 24], inter
   [313, 1160, 24]) and a ragged T, with (x, weights) in (bf16, bf16) and
   (bf16, fp32), the backward twice, bit-equal; their times, bounds,
   cuDNN's bf16 LSTM and the profiler's split of one backward call;
14. one bf16 flagship step as `train_stream` takes it (`cast_bf16`, the
   bf16 trunk) from `runs/finetune_r5/checkpoints/best.pt` on phase 7's
   batch: the kernel path against the plain path and against the JAX
   package's numbers (`runs/train_step_golden_bf16_jax.json`), 18 + 18
   mixed launches and no fp32 one; ms per bf16 step at the recipe (batch
   8 x 2.5 s) and its split;
15. `python -m sound_bubble_tpu_torch.train_stream` with the flagship
   recipe's arguments (`runs/finetune_r5/train_stream_args.json`) from the
   flagship checkpoint, the pool and the steps cut (`STREAM_CUTS`): steps,
   a validation, checkpoints, then a `--resume` with the other precision
   flag (the recorded bf16 is kept); the pool build seconds.

Phases 16-19 drive the attention nets (`use_attn: true`, L=4, E=2,
W=100), seeded weights of the flagship and the Orange Pi configurations
(`runs/attn_{flagship,orangpi}_seeded`, `tools/jax_goldens_attn.py`):

16. attention kernels vs plain: `gridnet_stack_step_attn` (row 3:
   `stack_walk_kernel<64, true, false>` and, on the conv_lstm pack, row 4:
   `stack_walk_kernel<64, true, true>`) against `gridnet_stack_step_attn_ref`,
   W + 5 = 105 chained steps (pos wraps the ring): x, h0, c0 and both rings;
17. attention serving: the 9 goldens of `test_samples/` through
   `FusedStreamer` (the in-kernel route) on both nets, per sample against
   the JAX package's numbers (`runs/goldens_attn_jax.json`), the first 20
   chunks of `syn_1m/00002` against the JAX output, and the per-block
   route (`attn_in_kernel=False`: the row-1 / row-2 kernel a block, the
   attention in PyTorch) against the in-kernel route on one clip;
18. times of the two attention kernels (CUDA events, and 20 calls in one
   CUDA graph), their plain versions, their bounds, and
   `FusedStreamer.feed` per chunk on both routes;
19. `train_pt` on `runs/attn_flagship_seeded/config.json` (fp32, batch 4 x
   2.5 s, 1 epoch, from the seeded weights), the slab launches per step;
   one step from the seeded weights on the kernel path against the plain
   path and against the JAX package's numbers for the same step in
   float64 (`runs/train_step_golden_attn_jax.json`: the fp32 JAX step is
   itself 1.5e-3 off in one PReLU slope's grad, see
   `tools/jax_train_step_golden.py`); ms per step, peak memory.

Phases 20-24 drive the custom-VJP kernel route (`--lstm_scan seq`:
`ops/kernels/lstm_train_kernel.py` on `csrc/lstm_seq.cu`,
`csrc/lstm_seq_fwd_mixed.cu` and, rows 7 and 9, the backward walk of
`csrc/lstm_seq_bwd.cu`; rows 6-9 of PERF.md's kernel table):

20. the four kernels against their plain versions at the flagship training
   shapes (intra [145, 1252, 32] both directions in one walk, inter
   [313, 580, 32]) and a ragged R (37), with (x, weights) in (fp32, fp32),
   (bf16, bf16) and (bf16, fp32), the walks' rows a block and blocks
   (rows 6-9) logged;
   the two autograd Functions' outputs and gradients, kernels against plain
   versions;
21. `train_pt --lstm_scan seq` on the flagship pretrain config, 1 epoch
   (the fp32 rows' main path; 6 launches of each row a step), and a resume
   with `--lstm_scan slab` refused; one step from the flagship checkpoint
   on the seq route against the slab route's and the JAX golden
   (`runs/train_step_golden_jax.json`: in fp32 JAX's custom-VJP route and
   its scans compute the same function);
22. one bf16 recipe step on the seq route against the same step on JAX's
   custom-VJP route (`runs/train_step_golden_bf16_seq_jax.json`,
   `tools/jax_train_step_golden_seq.py`; the slab route's golden, another
   rounding, printed beside it); `train_stream --lstm_scan seq`
   with the recipe cut (the mixed rows' main path), a `--resume`, and a
   resume with `--lstm_scan slab` refused;
23. one Orange Pi finetune step on the seq route against the slab route's
   and `runs/train_step_golden_edge_jax.json`;
24. times of rows 6-9 (fp32 at the fp32 step's shapes, mixed at the
   recipe's batch 8), their plain versions, bounds, cuDNN's LSTM (uni- and
   bidirectional); ms per step and peak memory, seq route against slab
   route, fp32 and the bf16 recipe.

Phases 25-28 drive the rest of serving on row 5, the fused inference BLSTM
(`ops/kernels/lstm_kernel.py` on `csrc/lstm_infer.cu`, the JAX package's
`blstm_pallas`, `SB_PALLAS_BLSTM=1`):

25. row 5 against its plain version at one stream (R = 1) and four at the
   flagship's width ([R, 145, 32]), one stream at the conv_lstm width
   ([1, 29, 24]) and the offline shape of a 2 s golden ([250, 145, 32]);
26. the 9 goldens of `test_samples/` streamed through the model-level
   `ModelWrapper` on the flagship's PLModule `model` handle with every intra
   BLSTM on row 5 (its main path: B launches a chunk, no slab launch),
   per sample against the JAX package's numbers; one clip against the same
   weights on the slab kernels and through `FusedStreamer`, and
   `streaming_inference_scan` (one CUDA graph of a chunk, replayed)
   against the loop;
27. `python -m sound_bubble_tpu_torch.eval_syn` on the three golden dirs
   and `python -m sound_bubble_tpu_torch.eval --distance_threshold -1` on
   the seeded Orange Pi run, as subprocesses at once with SB_PALLAS_BLSTM=1:
   row 5's launches (each CLI's last line), every column of `results.csv`
   against the JAX package's CLIs (`runs/goldens_eval_syn_jax.json`,
   `tools/jax_goldens_eval_syn.py`) and SI-SDRi / decay against
   `runs/goldens_test_samples_jax.json`;
28. times of row 5's whole function (one launch: projection and walk), its
   plain version, its bound and cuDNN's bidirectional LSTM at phase 25's
   shapes; ms a chunk of `ModelWrapper` on row 5 and on
   the slab kernels and of `streaming_inference_scan`; the offline forward
   and the eval CLIs' seconds a golden.

Phases 29-31 drive the data generation (`datagen/`, plain PyTorch and
numpy: no kernel of the table):

29. `campaign.build_pool(method="device")` (`rirs_on_device`, the image sum
   in the frequency domain on the card) at the flagship recipe's shapes
   (sr 24000, rir_len 12000, order U{10..32}, the background-noise slot), cut
   to 8 scenarios from 3000, against `method="host"` for the same seed:
   geometry and masks equal, each scenario's RIRs within a relative L2 error
   of 0.02; seconds a scenario by method, peak memory;
30. `on_device.make_training_batch` on the card at the recipe's batch (8 x
   2.5 s, phase 29's pool, formant voices), draws from a seeded generator:
   against the same call on the CPU to 1e-4 of the peak, the mixture before
   augmentation on its target SNR to 1e-3 dB; ms a batch;
31. a 6-speaker formant-voice corpus, then `python -m
   sound_bubble_tpu_torch.generate_adaptive_dataset` (6 train and 3 test
   samples of 2.5 s, `--max_order_max` cut to 20) and `make_eval_set --n 3
   --voice harmonic` (max order cut to 20) as subprocesses at once; `train_pt`
   at the flagship's width for one epoch on the generated dirs (slab
   kernels); `eval_syn` with `runs/finetune_r5` on each radius of the eval
   set: seconds a generated sample, mean SI-SDRi a radius.

Phase 32 drives the streaming step as one captured CUDA graph
(`runtime/fast_path.py`: `fused_scan_stream`, the JAX package's
whole-signal harness, and the graphed `FusedStreamer.feed`):

32. the 9 goldens through `fused_scan_stream` on the flagship (row 1), per
   sample against `runs/goldens_test_samples_jax.json` (0.01 dB); the first
   20 chunks of `syn_1m/00002` through the flagship, the Orange Pi edge net
   (row 2), both attention nets (rows 3 and 4, the ring slot advanced on
   the device) and their per-block route: `fused_scan_stream` and the
   graphed `feed` bit-equal to the eager step (`_step_impl`) in a loop, and
   one launch a chunk (B on the per-block route); ms a chunk on the host
   clock of the eager step, the graphed `feed` and a whole
   `fused_scan_stream` call, in turns, for each of the six.

Exits non-zero on any failed check, and when no card or no package is found.
The last three lines are the JSON record of the kernels, the card's name and
power limit, and the device line.
"""
import contextlib
import csv
import faulthandler
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(REPO, "runs", "finetune_r5")
# the flagship on the reference's own golden set (other audio than
# test_samples/): printed beside the results, for information
BASELINE = os.path.join(REPO, "runs", "goldens_baseline.json")
# the JAX package's fp32 numbers on test_samples/ themselves
# (tools/jax_goldens_test_samples.py): the results are held against these
JAX_BASELINE = os.path.join(REPO, "runs", "goldens_test_samples_jax.json")
GOLDENS = os.path.join(REPO, "test_samples")
RADII = (("1m", 1.0), ("1_5m", 1.5), ("2m", 2.0))
SEED = 0
KERNEL_TOL = 1e-4          # fp32 kernel vs fp32 plain version, max-abs
STREAM_REL_TOL = 1e-4      # kernel path vs ModelWrapper path, / output peak
# fp32 streaming on the card vs fp32 offline JAX on the CPU, per sample
PARITY_TOL_DB = 0.01
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12     # H100 SXM bf16 tensor cores, dense
PEAK_FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores
# slab kernels vs plain (fp32 vs fp32, other summation order): forward
# outputs max-abs; backward outputs max-abs over the output's peak (the dW
# sums run over T*R = 181,540 rows in another order)
SLAB_FWD_TOL = 1e-4
SLAB_BWD_REL_TOL = 1e-4
# train step, kernel path vs plain path on the card: only the LSTM scans
# differ (summation order), through 6 blocks
STEP_LOSS_REL_TOL = 1e-5
STEP_NORM_REL_TOL = 1e-4
# train step on the card vs the JAX package in fp32 on the CPU (another
# device, convolution and matmul libraries): on the CPU the port agrees to
# 1.1e-5 (loss), 2.8e-6 (global norm), 1.2e-4 (worst leaf)
GOLDEN_LOSS_REL_TOL = 1e-4
GOLDEN_NORM_REL_TOL = 1e-4
GOLDEN_LEAF_REL_TOL = 1e-3
TRAIN_STEP_GOLDEN = os.path.join(REPO, "runs", "train_step_golden_jax.json")
TRAIN_CONFIG = os.path.join(REPO, "syn_experiments", "pretrain_stage.json")
# the edge model: seeded weights and the JAX package's numbers for them
# (tools/jax_goldens_edge.py, tools/jax_train_step_golden.py --edge)
EDGE_RUN_DIR = os.path.join(REPO, "runs", "edge_orangpi_seeded")
EDGE_GOLDENS = os.path.join(REPO, "runs", "goldens_edge_jax.json")
EDGE_STEP_GOLDEN = os.path.join(REPO, "runs",
                                "train_step_golden_edge_jax.json")
EDGE_CONFIG = os.path.join(REPO, "real_experiments",
                           "{}_model_{}.json")   # (orangpi|raspberrypi, stage)
# the first 20 streamed chunks vs the JAX output, max-abs / peak (fp32 on the
# card vs fp32 on the CPU: the port's CPU path agrees to 8.3e-6)
EDGE_HEAD_REL_TOL = 1e-4
# the bf16 flagship step (train_stream --bf16) against the JAX package's
# (tools/jax_train_step_golden.py --bf16), and the kernel path against the
# plain path on the card
BF16_STEP_GOLDEN = os.path.join(REPO, "runs",
                                "train_step_golden_bf16_jax.json")
BF16_LOSS_REL_TOL = 1e-2
BF16_NORM_REL_TOL = 3e-2
# the same bf16 step on JAX's custom-VJP kernel route
# (tools/jax_train_step_golden_seq.py): the seq route rounds otherwise than
# the slab route, so its bf16 step is held to this golden, at the same bars
BF16_SEQ_STEP_GOLDEN = os.path.join(REPO, "runs",
                                    "train_step_golden_bf16_seq_jax.json")
# phase 15's cuts of the flagship campaign (pool of 3000 scenarios, 180 for
# validation, 8 validation batches, 20000 steps): the pool and the steps
STREAM_CUTS = ["--pool", "24", "--val_pool", "8", "--val_batches", "1",
               "--log_every", "2"]
STREAM_STEPS = (4, 4)          # steps, val_every
# the attention nets: seeded weights and the JAX package's numbers for them
# (tools/jax_goldens_attn.py, tools/jax_train_step_golden.py --attn)
ATTN_RUN_DIRS = {"flagship": os.path.join(REPO, "runs",
                                          "attn_flagship_seeded"),
                 "orangpi": os.path.join(REPO, "runs", "attn_orangpi_seeded")}
ATTN_GOLDENS = os.path.join(REPO, "runs", "goldens_attn_jax.json")
ATTN_STEP_GOLDEN = os.path.join(REPO, "runs",
                                "train_step_golden_attn_jax.json")
T0 = time.perf_counter()


def log(msg):
    print(f"[{time.perf_counter() - T0:8.2f} s] {msg}", flush=True)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, n):
    """Mean device time of fn() over n calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def stack_step_bound_ms(n_blocks, f, d, h, film, s=None, attn=None):
    """Least time for one stack step on an H100: the larger of the bytes the
    step must move and its fp32 arithmetic over the fp32 rate. Both count the
    compact math, not the packed operands: the fused BLSTM packing pads each
    direction's input weights [D, 4H] to [D, 8H] and the recurrent weights
    into a block-diagonal [2H, 8H], and those zeros are no work the step
    needs; the conv branch (lstm_down s) counts each row's own phase of the
    down conv, not the s phases the phase-split form computes. Bytes: weights
    read once, x/h0/c0 (and FiLM) read once, x/h0/c0 written once.

    attn = (heads L, key width E, window W): the attention step adds its
    weights, the whole K/V rings read once (B*W*F*(L*E + D) floats) and the
    new slot written once (B*F*(L*E + D)); and per block the q/k/v and
    output projections, the scores over the W slots and the weighted sum of
    the values (the softmax and the LayerNorms are O(F*D), not counted)."""
    lstm_w = (2 * d * 4 * h                # fwd + bwd input weights
              + 2 * h * 4 * h              # fwd + bwd recurrent weights
              + 8 * h)                     # fwd + bwd biases
    inter_w = (2 * d                       # inter LayerNorm
               + (d + h) * 4 * h + 4 * h   # inter LSTM
               + h * d + d)                # inter projection
    inter_ops = (2 * f * (d + h) * 4 * h   # inter gates
                 + 2 * f * h * d)          # inter projection
    if s is None:
        n = f                              # intra rows
        weights = (2 * d                   # intra LayerNorm scale, bias
                   + lstm_w + 2 * h * d + d + inter_w)  # + intra projection
        intra_ops = 2 * f * 2 * h * d      # intra projection
    else:
        n = f // s                         # conv frames
        weights = (s * d * d + d + 1       # down conv, PReLU slope
                   + 2 * d                 # intra LayerNorm
                   + lstm_w + 2 * h * s * d + d + inter_w)  # + up conv
        intra_ops = (2 * n * s * d * d     # down conv
                     + 2 * n * 2 * h * s * d)  # up conv
    acts = 2 * (f * d + 2 * n_blocks * f * h)   # x, h0, c0 in and out
    film_floats = 2 * (n_blocks - 1) * f * d if film else 0
    attn_ops = ring_floats = 0
    if attn is not None:
        heads, e, w = attn
        le = heads * e
        weights += (d * (2 * le + d) + 2 * le + d + 3  # q, k, v Linear, PReLU
                    + 2 * f * (2 * e + d // heads)     # their LayerNorms
                    + d * d + d + 1 + 2 * f * d)       # output Linear, LN
        ring_floats = n_blocks * f * (le + d) * (w + 1)  # read all, write 1
        attn_ops = (2 * f * d * (2 * le + d)      # q, k, v projections
                    + 2 * f * d * d               # output projection
                    + 2 * heads * w * f * e       # scores
                    + 2 * d * w * f)              # weighted values
    n_bytes = 4 * (n_blocks * weights + acts + film_floats + ring_floats)
    per_block = (2 * 2 * n * d * 4 * h      # fwd + bwd input projections
                 + 2 * 2 * n * h * 4 * h    # fwd + bwd recurrence
                 + intra_ops + inter_ops + attn_ops)
    flops = n_blocks * per_block
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    log(f"bound: {n_bytes} B -> {t_bytes:.6f} ms at 3.35 TB/s; "
        f"{flops} FLOP -> {t_ops:.6f} ms at 67 TFLOP/s fp32; dependency "
        f"chain {n_blocks * (n + 1)} sequential cell updates"
        + ("" if attn is None else f"; K/V rings {4 * ring_floats} B read "
           "and written"))
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# (name, T, R, C, reverse): the intra BLSTM directions and the inter LSTM of
# the flagship training path (batch 4 x 2.5 s: T*R = 181,540 rows), of the
# edge training path (Orange Pi C=24: k = 145 // 5 = 29 conv frames; one
# Raspberry Pi C=16 case), and a ragged case
SLAB_SHAPES = (("intra", 145, 1252, 32, False),
               ("intra_rev", 145, 1252, 32, True),
               ("inter", 313, 580, 32, False),
               ("edge_intra", 29, 1252, 24, False),
               ("edge_intra_rev", 29, 1252, 24, True),
               ("edge_inter", 313, 580, 24, False),
               ("rpi_intra", 29, 1252, 16, False),
               ("ragged", 13, 37, 32, False), ("ragged_rev", 13, 37, 32, True))
SLAB_H = 64
# slab launches per train step: 6 blocks x (2 intra directions + 1 inter),
# 12 at the intra shape and 6 at the inter shape
SLAB_MIX = (("intra", 12), ("inter", 6))


def slab_bound_ms(t_len, r, c, h, kind, xb=4, wb=4):
    """Least time for one slab scan on an H100: the larger of the bytes it
    must move (each input read once, each output written once) over 3.35
    TB/s and its matrix-product FLOPs over the fp32 rate (the gate
    nonlinearities, ~2 % more, are not counted). The mixed mode (xb = 2:
    x, ys, dy and dx in bf16; wb = 2 or 4 for the weights and hp) counts
    those tensors at 2 bytes, the fp32 state, checkpoints and weight
    gradients at 4, and its products at the bf16 tensor-core rate (989
    TFLOP/s dense): bf16 operands with fp32 accumulation."""
    nb = -(-t_len // min(8, t_len))
    n, g = t_len * r, 4 * h
    w = (c + h) * g + g                             # w_ih, w_hh, b
    state = 2 * r * h                               # (h, c) or their grads
    if kind == "fwd":
        flops = 2 * n * (c + h) * g
        n_bytes = (xb * n * c + wb * w + 4 * state             # in
                   + xb * n * h + 4 * nb * r * h + 4 * state)  # ys, c_ckpt
    else:
        flops = (2 * n * (c + h) * g          # gate recompute
                 + 2 * n * g * h              # dh chain: dgates @ w_hh^T
                 + 2 * n * g * c              # dx = dgates @ w_ih^T
                 + 2 * n * (c + h + 1) * g)   # dW_ih, dW_hh, db
        n_bytes = (xb * n * c + wb * n * h + xb * n * h      # x, hp, dy
                   + 4 * nb * r * h + wb * w + 4 * state     # c_ckpt, in
                   + xb * n * c + 4 * w + 4 * state)         # out
    peak = PEAK_FP32_FLOPS if xb == 4 and wb == 4 else PEAK_BF16_FLOPS
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")), flops, n_bytes


def slab_case(dev, t_len, r, c, seed):
    """Operands of one slab scan, weights from the LSTM's initial
    distribution U(-1/sqrt(H), 1/sqrt(H)), activations N(0, 1)."""
    rng = np.random.default_rng(seed)
    h = SLAB_H

    def draw(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    def uniform(*shape):
        return torch.from_numpy(rng.uniform(
            -h ** -0.5, h ** -0.5, shape).astype(np.float32)).to(dev)

    return dict(w_ih=uniform(c, 4 * h), w_hh=uniform(h, 4 * h),
                b=uniform(4 * h), x=draw(t_len, r, c), h0=draw(r, h) * 0.5,
                c0=draw(r, h) * 0.5, dy=draw(t_len, r, h), dhT=draw(r, h),
                dcT=draw(r, h))


def slab_args(a, ls, reverse, ys=None):
    fwd = (a["w_ih"], a["w_hh"], a["b"], a["x"], a["h0"], a["c0"], reverse)
    if ys is None:
        return fwd
    return (a["w_ih"], a["w_hh"], a["b"], a["x"],
            ls.shift_prev(ys[0], a["h0"], reverse, a["w_hh"].dtype), ys[3],
            a["dy"], a["dhT"], a["dcT"], reverse)


@contextlib.contextmanager
def plain_slab(ls):
    """Route the LSTM scans to the slab kernels' plain versions, on the
    card: the reference the kernel path is held against."""
    saved = ls.lstm_slab_fwd, ls.lstm_slab_bwd
    ls.lstm_slab_fwd, ls.lstm_slab_bwd = (ls.lstm_slab_fwd_ref,
                                          ls.lstm_slab_bwd_ref)
    try:
        yield
    finally:
        ls.lstm_slab_fwd, ls.lstm_slab_bwd = saved


def phase6_slab(dev, ls):
    """Both slab kernels against their plain versions. Returns the max-abs
    errors (forward, backward)."""
    fwd_err = bwd_err = 0.0
    for i, (name, t_len, r, c, reverse) in enumerate(SLAB_SHAPES):
        a = slab_case(dev, t_len, r, c, SEED + i)
        f0, b0 = ls.lstm_slab_fwd.launches, ls.lstm_slab_bwd.launches
        with torch.no_grad():
            got = ls.lstm_slab_fwd(*slab_args(a, ls, reverse))
            torch.cuda.synchronize()
            want = ls.lstm_slab_fwd_ref(*slab_args(a, ls, reverse))
            errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
            got_b = ls.lstm_slab_bwd(*slab_args(a, ls, reverse, want))
            again_b = ls.lstm_slab_bwd(*slab_args(a, ls, reverse, want))
            torch.cuda.synchronize()
            same = all(torch.equal(g, h) for g, h in zip(got_b, again_b))
            want_b = ls.lstm_slab_bwd_ref(*slab_args(a, ls, reverse, want))
            abs_b = [float((g - w).abs().max()) for g, w in zip(got_b, want_b)]
            rel_b = [e / float(w.abs().max()) for e, w in zip(abs_b, want_b)]
        launched = (ls.lstm_slab_fwd.launches - f0,
                    ls.lstm_slab_bwd.launches - b0)
        rows, blocks = ls.fwd_row_tiles(r, c, SLAB_H, ls._n_sm(dev))
        log(f"  {name} [T={t_len}, R={r}, C={c}], H={SLAB_H}: forward "
            f"({rows} rows a block, {blocks} blocks) "
            f"max-abs (ys, hT, cT, c_ckpt) {['%.2e' % e for e in errs]}; "
            f"backward max-abs / peak (dx, dw_ih, dw_hh, db, dh0, dc0) "
            f"{['%.2e' % e for e in rel_b]}; two backward launches "
            f"bit-equal: {same}; launches {launched}")
        if not same:
            fail(f"two slab backward launches differ at {name}")
        if not max(errs) <= SLAB_FWD_TOL:
            fail(f"slab forward kernel disagrees at {name}: {errs}")
        if not max(rel_b) <= SLAB_BWD_REL_TOL:
            fail(f"slab backward kernel disagrees at {name}: {rel_b}")
        if launched != (1, 2):
            fail(f"slab kernel launches grew by {launched}, expected (1, 2)")
        fwd_err, bwd_err = max(fwd_err, *errs), max(bwd_err, *abs_b)
    log(f"phase 6 slab kernels vs plain: forward max-abs {fwd_err:.3e} "
        f"(tol {SLAB_FWD_TOL}), backward max-abs {bwd_err:.3e} (each output "
        f"within {SLAB_BWD_REL_TOL} of its peak)")
    return fwd_err, bwd_err


def check_adam_step(name, got, want, grad, lr):
    """The first Adam step moves a weight by lr * g / (|g| + eps): +-lr
    whatever |g| once |g| >> eps. Where |g| > 1e-3 of the leaf's peak the
    two updated weights agree to 1e-6; where g is that close to 0 the two
    paths' last digits can give another fraction of lr: 2 lr there."""
    big = np.abs(grad) > 1e-3 * np.abs(grad).max()
    err_big = float(np.abs(got - want)[big].max()) if big.any() else 0.0
    err_all = float(np.abs(got - want).max())
    if not (err_big <= 1e-6 and err_all <= 2 * lr + 1e-6):
        fail(f"updated {name}: kernel vs plain {err_big} (|g| large), "
             f"{err_all} (all)")
    return err_big


def run_train_pt(cfg, cfg_path, run_dir, epochs, ls, extra=()):
    """`train_pt` for `epochs` on the config dict `cfg` (written to
    cfg_path), with the arguments `extra`; the slab launch counts are set to
    0 just before. Returns (the PLModule, seconds, forward launches,
    backward launches)."""
    from sound_bubble_tpu_torch import train_pt

    cfg["epochs"] = epochs
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh)
    ls.lstm_slab_fwd.launches = ls.lstm_slab_bwd.launches = 0
    t = time.perf_counter()
    hl = train_pt.train(train_pt.parse_args(
        ["--config", cfg_path, "--run_dir", run_dir, "--seed", str(SEED),
         *extra]))
    torch.cuda.synchronize()
    return (hl, time.perf_counter() - t, ls.lstm_slab_fwd.launches,
            ls.lstm_slab_bwd.launches)


def point_at_scenes(cfg, dirs):
    """The config's dataset paths -> the seeded synthetic sample dirs."""
    for split, key in (("train", "train_data_args"),
                       ("val", "val_data_args")):
        cfg[key]["dataset_dirs"] = [
            {"path": p, "max_samples": 10000} for p in dirs[split]]


def check_step_golden(loss_k, norm_k, grads_k, grad_clip, golden_path):
    """One train step on the card against the JAX package's numbers for the
    same step (fp32 on the CPU, or float64 where the golden says so):
    loss, pre-clip global grad norm, per-leaf grad norms (grads_k were
    clipped in place by the step)."""
    with open(golden_path) as fh:
        golden = json.load(fh)
    # the step clipped the gradients in place by min(1, max_norm / norm)
    scale = min(1.0, grad_clip / norm_k)
    leaf_rel = {k: abs(float(np.sqrt(np.sum(np.square(g, dtype=np.float64))))
                       / scale - golden["grad_norms"][k])
                / golden["grad_norms"][k] for k, g in grads_k.items()}
    worst = max(leaf_rel, key=leaf_rel.get)
    g_loss = abs(loss_k - golden["loss"]) / abs(golden["loss"])
    g_norm = abs(norm_k - golden["grad_norm"]) / golden["grad_norm"]
    log(f"  one step vs the JAX package ("
        f"{golden.get('precision', 'fp32')}, CPU; "
        f"{os.path.basename(golden_path)}): loss {loss_k:.6f} vs "
        f"{golden['loss']:.6f} (rel {g_loss:.2e}, tol {GOLDEN_LOSS_REL_TOL}); "
        f"grad norm {norm_k:.6f} vs {golden['grad_norm']:.6f} (rel "
        f"{g_norm:.2e}, tol {GOLDEN_NORM_REL_TOL}); per-leaf grad norms, "
        f"worst {worst} rel {leaf_rel[worst]:.2e} (tol "
        f"{GOLDEN_LEAF_REL_TOL}), {len(leaf_rel)} leaves")
    if set(leaf_rel) != set(golden["grad_norms"]):
        fail("the golden names other parameters than the port's model")
    if not (g_loss <= GOLDEN_LOSS_REL_TOL and g_norm <= GOLDEN_NORM_REL_TOL
            and leaf_rel[worst] <= GOLDEN_LEAF_REL_TOL):
        fail(f"the first train step disagrees with "
             f"{os.path.basename(golden_path)}")


def train_step_ms(mod, batch, dev):
    """ms per PLModule.train_step on the batch, host clock, 5 steps after
    one warm-up; and the peak device memory in GB."""
    model_inputs = mod._model_inputs(batch[0])
    target = torch.from_numpy(batch[1]["target"]).to(dev)
    mod.train_step(model_inputs, target)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(5):
        mod.train_step(model_inputs, target)
    torch.cuda.synchronize()
    return ((time.perf_counter() - t) / 5 * 1e3,
            torch.cuda.max_memory_allocated() / 1e9)


def phase7_train(dev):
    """Train through train_pt (2 epochs, then a resumed third); the kernel
    path against the plain path for one step; one step against the JAX
    package's golden. Returns the main path's launch counts and the module
    used for the step, on the card."""
    from sound_bubble_tpu_torch.data.synth import (
        golden_batch, write_sample_dirs)
    from sound_bubble_tpu_torch.ops.kernels import lstm_slab as ls
    from sound_bubble_tpu_torch.train.checkpoint import load_checkpoint
    from sound_bubble_tpu_torch.train.module import PLModule
    from sound_bubble_tpu_torch.utils import seed_all
    from sound_bubble_tpu_torch.weights import from_jax_params

    with open(TRAIN_CONFIG) as fh:
        cfg = json.load(fh)
    args = cfg["pl_module_args"]
    n_scans = 3 * args["model_params"]["B"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        n_train, n_val = 4, 2
        dirs = write_sample_dirs(os.path.join(tmp, "data"), SEED, n_train,
                                 n_val)
        point_at_scenes(cfg, dirs)
        cfg["num_workers"] = 2
        steps = math.ceil(3 * n_train / cfg["batch_size"])
        val_batches = math.ceil(3 * n_val / cfg["eval_batch_size"])
        cfg_path, run_dir = (os.path.join(tmp, "config.json"),
                             os.path.join(tmp, "run"))
        last_path = os.path.join(run_dir, "checkpoints", "last.pt")
        best_path = os.path.join(run_dir, "checkpoints", "best.pt")

        # train_pt seeds every generator, then builds the module: the same
        # construction gives the weights it starts from
        seed_all(SEED)
        init = {k: v.numpy().copy() for k, v in
                PLModule(**args, device="cpu").net.state_dict().items()}

        def run(epochs):
            return run_train_pt(cfg, cfg_path, run_dir, epochs, ls)

        def moved(before, after, what):
            still = [k for k, v in before.items()
                     if not np.abs(np.asarray(after[k]) - v).max() > 0]
            if still:
                fail(f"{what}: weights did not move: {still}")

        def flat(tree):
            return {k: v.numpy() for k, v in from_jax_params(tree).items()}

        # ---- the main path: 2 epochs
        hl, train_s, fwd_n, bwd_n = run(2)
        want = (2 * (steps + val_batches) * n_scans, 2 * steps * n_scans)
        log(f"phase 7 training: train_pt, 2 epochs x {steps} steps + "
            f"{val_batches} val batch(es) in {train_s:.2f} s; slab launches "
            f"fwd {fwd_n}, bwd {bwd_n} (expected {want[0]}, {want[1]}: "
            f"{n_scans} per step, {n_scans} fwd per val batch)")
        if (fwd_n, bwd_n) != want:
            fail(f"slab launches {(fwd_n, bwd_n)}, expected {want}")
        with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
            logged = [json.loads(line) for line in fh]
        losses = [e[k] for e in logged for k in ("train/loss", "val/loss")]
        log(f"  epoch losses (train, val): {losses}")
        if len(logged) != 2 or not np.isfinite(losses).all():
            fail(f"run log: {logged}")
        last, best = load_checkpoint(last_path), load_checkpoint(best_path)
        if last["current_epoch"] != 2 or hl.epoch != 2:
            fail(f"last.pt at epoch {last['current_epoch']}")
        moved(init, flat(last["model"]), "2 epochs")
        if set(flat(best["model"])) != set(init):
            fail("best.pt does not hold the model's weights")
        launches = (fwd_n, bwd_n)

        # ---- resume: a third epoch from last.pt
        hl, resume_s, fwd_n, bwd_n = run(3)
        want = ((steps + val_batches) * n_scans, steps * n_scans)
        last3 = load_checkpoint(last_path)
        log(f"  resumed from last.pt at epoch 2: 1 epoch in {resume_s:.2f} "
            f"s, slab launches fwd {fwd_n}, bwd {bwd_n} (expected "
            f"{want[0]}, {want[1]}), last.pt now at epoch "
            f"{last3['current_epoch']}")
        if (fwd_n, bwd_n) != want or last3["current_epoch"] != 3:
            fail("the resumed run did not take exactly one more epoch")
        moved(flat(last["model"]), flat(last3["model"]), "resumed epoch")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- one step from the flagship on the golden batch: kernel path,
    # plain path, JAX golden
    batch = golden_batch(SEED)
    flagship = os.path.join(RUN_DIR, "checkpoints", "best.pt")
    mod, loss_k, norm_k, grads_k = kernel_vs_plain_step(
        args, flagship, batch, n_scans, dev, ls)
    check_step_golden(loss_k, norm_k, grads_k, args["grad_clip"],
                      TRAIN_STEP_GOLDEN)
    return launches, mod, batch


def kernel_vs_plain_step(args, init_ckpt, batch, n_scans, dev, ls):
    """One train step from `init_ckpt` on `batch` on the kernel path and on
    the plain path (the slab kernels' plain versions), on the card: loss,
    pre-clip grad norm and updated weights agree, and the kernel path
    launched each slab kernel n_scans times. Returns the kernel path's
    (module, loss, pre-clip grad norm, clipped grads)."""
    from sound_bubble_tpu_torch.train.module import PLModule

    def one_step(plain):
        mod = PLModule(**{**args, "init_ckpt": init_ckpt}, device=dev)
        f0, b0 = ls.lstm_slab_fwd.launches, ls.lstm_slab_bwd.launches
        with plain_slab(ls) if plain else contextlib.nullcontext():
            loss, _ = mod.training_step(batch)
        torch.cuda.synchronize()
        grads = {k: p.grad.cpu().numpy() for k, p in
                 mod.net.named_parameters()}
        weights = {k: v.cpu().numpy() for k, v in
                   mod.net.state_dict().items()}
        return (mod, loss, float(mod.last_grad_norm), grads, weights,
                (ls.lstm_slab_fwd.launches - f0,
                 ls.lstm_slab_bwd.launches - b0))

    mod, loss_k, norm_k, grads_k, w_k, per_step = one_step(False)
    _, loss_p, norm_p, grads_p, w_p, plain_step = one_step(True)
    if per_step != (n_scans, n_scans) or plain_step != (0, 0):
        fail(f"slab launches in one step: kernel path {per_step}, plain "
             f"path {plain_step}; expected ({n_scans}, {n_scans}) and (0, 0)")
    lr = mod.get_current_lr()
    w_err = max(check_adam_step(k, w_k[k], w_p[k], grads_p[k], lr)
                for k in w_k)
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    rel_norm = abs(norm_k - norm_p) / norm_p
    log(f"  one step from {os.path.relpath(init_ckpt, REPO)}, kernel path "
        f"vs plain path on the card: loss {loss_k:.6f} vs {loss_p:.6f} (rel "
        f"{rel_loss:.2e}, tol {STEP_LOSS_REL_TOL}); pre-clip grad norm "
        f"{norm_k:.6f} vs {norm_p:.6f} (rel {rel_norm:.2e}, tol "
        f"{STEP_NORM_REL_TOL}); updated weights max-abs {w_err:.2e} where "
        f"|g| > 1e-3 of the leaf's peak; slab launches per step {per_step}")
    if not (rel_loss <= STEP_LOSS_REL_TOL and rel_norm <= STEP_NORM_REL_TOL):
        fail("kernel path and plain path disagree on one train step")
    return mod, loss_k, norm_k, grads_k


def cudnn_lstm_ms(dev, a, n, dtype=torch.float32, bidirectional=False):
    """cuDNN's LSTM on the same shapes in `dtype` (fp32 with TF32 off, or
    bf16), the library yardstick; the port never calls it: (forward,
    backward) ms, the backward as forward+backward minus forward, both in
    training mode. `bidirectional`: both directions from zero states, dy
    [T, R, 2H]."""
    t_len, r, c = a["x"].shape
    lstm = torch.nn.LSTM(c, SLAB_H, bidirectional=bidirectional).to(dev,
                                                                     dtype)
    x = a["x"].to(dtype).clone().requires_grad_()
    hc = None if bidirectional else (a["h0"][None].to(dtype),
                                     a["c0"][None].to(dtype))
    dy = a["dy"].to(dtype)

    def fwd():
        return lstm(x, hc)[0]

    def fwd_bwd():
        fwd().backward(dy)

    fwd_bwd()
    fwd_ms = cuda_ms(fwd, n)
    both_ms = cuda_ms(fwd_bwd, n)
    return fwd_ms, both_ms - fwd_ms


def phase8_times(dev, ls, mod, batch):
    """Per-launch times at the two training shapes; ms per train step."""
    from tools.time_stack_kernels import profile_split

    rows = {}
    shapes = {name: rest for name, *rest in SLAB_SHAPES}
    for name, _ in SLAB_MIX:
        t_len, r, c, reverse = shapes[name]
        a = slab_case(dev, t_len, r, c, SEED)
        with torch.no_grad():
            ys = ls.lstm_slab_fwd(*slab_args(a, ls, reverse))
            bargs = slab_args(a, ls, reverse, ys)
            fwd_ms = cuda_ms(lambda: ls.lstm_slab_fwd(
                *slab_args(a, ls, reverse)), 20)
            bwd_ms = cuda_ms(lambda: ls.lstm_slab_bwd(*bargs), 20)
            fwd_plain = cuda_ms(lambda: ls.lstm_slab_fwd_ref(
                *slab_args(a, ls, reverse)), 2)
            bwd_plain = cuda_ms(lambda: ls.lstm_slab_bwd_ref(*bargs), 2)
            split = profile_split(lambda: ls.lstm_slab_bwd(*bargs))
        lib_fwd, lib_bwd = cudnn_lstm_ms(dev, a, 10)
        (fb, fby), ff, fbytes = slab_bound_ms(t_len, r, c, SLAB_H, "fwd")
        (bb, bby), bf, bbytes = slab_bound_ms(t_len, r, c, SLAB_H, "bwd")
        rows[name] = {"fwd": (fwd_ms, fwd_plain, fb, fby, lib_fwd),
                      "bwd": (bwd_ms, bwd_plain, bb, bby, lib_bwd)}
        log(f"  {name} [T={t_len}, R={r}]: fwd {fwd_ms:.4f} ms (plain "
            f"{fwd_plain:.2f}, cuDNN LSTM fwd {lib_fwd:.4f}, bound {fb:.6f} "
            f"{fby}: {ff} FLOP, {fbytes} B); bwd {bwd_ms:.4f} ms (plain "
            f"{bwd_plain:.2f}, cuDNN LSTM bwd {lib_bwd:.4f}, bound {bb:.6f} "
            f"{bby}: {bf} FLOP, {bbytes} B); torch.profiler split of one "
            f"backward call, device us: {split}")

    # ms per train step: PLModule.train_step on the golden batch, host clock
    step_ms, peak_gb = train_step_ms(mod, batch, dev)

    total = sum(k for _, k in SLAB_MIX)
    mixed = {}
    for kind in ("fwd", "bwd"):
        vals = [sum(rows[name][kind][i] * k for name, k in SLAB_MIX) / total
                for i in (0, 1, 2, 4)]
        by = rows["intra"][kind][3]
        mixed[kind] = dict(zip(("ms", "plain_ms", "bound_ms", "library_ms"),
                               vals), bound_by=by)
    log(f"phase 8 times: train step {step_ms:.2f} ms (PLModule.train_step, "
        f"batch 4 x 2.5 s, host clock, 5 steps), peak device memory "
        f"{peak_gb:.2f} GB; per slab launch on the path (12 intra : 6 "
        f"inter): fwd {mixed['fwd']['ms']:.4f} ms, bwd "
        f"{mixed['bwd']['ms']:.4f} ms")
    return mixed, step_ms


# (name, T, R, C, reverse): the mixed slab kernels at the flagship recipe's
# shapes (train_stream --bf16, batch 8 x 2.5 s: intra [145, 2504, 32] both
# directions, inter [313, 1160, 32]), the edge model's at the same batch
# (intra [29, 2504, 24], inter [313, 1160, 24]) and a ragged T, each with
# (x, weights) in (bf16, bf16) (cast_bf16) and (bf16, fp32) (train_pt --bf16)
MIXED_SHAPES = (("intra", 145, 2504, 32, False),
                ("intra_rev", 145, 2504, 32, True),
                ("inter", 313, 1160, 32, False),
                ("edge_intra", 29, 2504, 24, False),
                ("edge_inter", 313, 1160, 24, False),
                ("ragged_rev", 13, 37, 32, True))
# mixed kernel vs its plain version: the same roundings, but fp32 sums in
# another order move some gates across a bf16 rounding boundary, and the
# recurrence carries such a flip on through the later frames. Every output
# within 1e-2 of its peak; ys within one bf16 ulp of its peak (`bf16_ulp`:
# 2^-8 for a peak in [0.5, 1)) at all but MIXED_YS_FRAC of its elements
MIXED_REL_TOL = 1e-2
MIXED_YS_FRAC = 1e-6


def bf16_ulp(v):
    """The spacing of bf16 values at |v| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(v))) - 7)


def mixed_case(a, wdt):
    """The fp32 operands of slab_case in the mixed mode: x and dy in bf16,
    the weights in wdt, the state in fp32."""
    m = dict(a, x=a["x"].bfloat16(), dy=a["dy"].bfloat16())
    for k in ("w_ih", "w_hh", "b"):
        m[k] = a[k].to(wdt)
    return m


def rel_errs(got, want):
    """(max-abs, max-abs over want's peak, want's peak) of each output."""
    out = []
    for g, w in zip(got, want):
        err = float((g.float() - w.float()).abs().max())
        peak = max(float(w.float().abs().max()), 1e-30)
        out.append((err, err / peak, peak))
    return out


def mixed_counts(ls):
    return (ls.lstm_slab_fwd.launches, ls.lstm_slab_bwd.launches,
            ls.lstm_slab_fwd.mixed_launches, ls.lstm_slab_bwd.mixed_launches)


def phase13_mixed_slab(dev, ls):
    """The mixed slab kernels against their plain versions on the card.
    Returns the worst max-abs errors (forward, backward)."""
    fwd_err = bwd_err = 0.0
    for i, (name, t_len, r, c, reverse) in enumerate(MIXED_SHAPES):
        base = slab_case(dev, t_len, r, c, SEED + 100 + i)
        for wdt in (torch.bfloat16, torch.float32):
            a = mixed_case(base, wdt)
            before = mixed_counts(ls)
            with torch.no_grad():
                got = ls.lstm_slab_fwd(*slab_args(a, ls, reverse))
                torch.cuda.synchronize()
                want = ls.lstm_slab_fwd_ref(*slab_args(a, ls, reverse))
                f_errs = rel_errs(got, want)
                got_b = ls.lstm_slab_bwd(*slab_args(a, ls, reverse, want))
                again_b = ls.lstm_slab_bwd(*slab_args(a, ls, reverse, want))
                torch.cuda.synchronize()
                same = all(torch.equal(g, h) for g, h in zip(got_b, again_b))
                want_b = ls.lstm_slab_bwd_ref(*slab_args(a, ls, reverse,
                                                         want))
                b_errs = rel_errs(got_b, want_b)
            grew = tuple(n - m for n, m in zip(mixed_counts(ls), before))
            wname = "bf16" if wdt == torch.bfloat16 else "fp32"
            code = ls.DTYPES.index((torch.bfloat16, wdt))
            log(f"  {name} [T={t_len}, R={r}, C={c}], H={SLAB_H}, x bf16, "
                f"weights {wname} (row 10b %d rows a block, %d blocks): "
                % ls.fwd_row_tiles(r, c, SLAB_H, ls._n_sm(dev), code=code)
                + "forward max-abs / peak (ys, hT, cT, "
                f"c_ckpt) {['%.2e' % e[1] for e in f_errs]}; backward "
                f"(dx, dw_ih, dw_hh, db, dh0, dc0) "
                f"{['%.2e' % e[1] for e in b_errs]}; two backward launches "
                f"bit-equal: {same}; launches fp32 {grew[:2]}, mixed "
                f"{grew[2:]}")
            if not same:
                fail(f"two mixed slab backward launches differ at {name} "
                     f"({wname} weights)")
            if (got[0].dtype, got_b[0].dtype) != (torch.bfloat16,) * 2:
                fail(f"mixed slab kernels at {name}: ys {got[0].dtype}, dx "
                     f"{got_b[0].dtype}, expected bfloat16")
            ys_ulp = bf16_ulp(f_errs[0][2])
            ys_frac = float(((got[0].float() - want[0].float()).abs()
                             > ys_ulp).float().mean())
            log(f"    ys max-abs {f_errs[0][0]:.3e}; one bf16 ulp of its "
                f"peak {f_errs[0][2]:.4f} is {ys_ulp:.3e}, exceeded at "
                f"{ys_frac:.2e} of the elements")
            if not (ys_frac <= MIXED_YS_FRAC
                    and max(e[1] for e in f_errs) <= MIXED_REL_TOL):
                fail(f"mixed slab forward kernel disagrees at {name} "
                     f"({wname} weights): {f_errs}")
            if not max(e[1] for e in b_errs) <= MIXED_REL_TOL:
                fail(f"mixed slab backward kernel disagrees at {name} "
                     f"({wname} weights): {b_errs}")
            if grew != (0, 0, 1, 2):
                fail(f"slab launches grew by {grew}, expected fp32 (0, 0) "
                     f"and mixed (1, 2)")
            fwd_err = max(fwd_err, *(e[0] for e in f_errs))
            bwd_err = max(bwd_err, *(e[0] for e in b_errs))
    log(f"phase 13 mixed slab kernels vs plain: forward max-abs {fwd_err:.3e}"
        f", backward max-abs {bwd_err:.3e} (every output within "
        f"{MIXED_REL_TOL} of its peak; ys within one bf16 ulp of its peak "
        f"at all but {MIXED_YS_FRAC} of its elements)")
    return fwd_err, bwd_err


def mixed_slab_times(dev, ls, card):
    """Per-launch times of the mixed kernels ((bf16, bf16), the campaign
    trainer's operands) at the recipe's intra and inter shapes, with their
    bound, their plain versions and cuDNN's bf16 LSTM. Returns the means over
    a step's 12 intra : 6 inter launches, for the kernels line, and the
    per-shape rows."""
    from tools.time_stack_kernels import profile_split

    rows = {}
    shapes = {name: rest for name, *rest in MIXED_SHAPES}
    for name, _ in SLAB_MIX:
        t_len, r, c, reverse = shapes[name]
        a = mixed_case(slab_case(dev, t_len, r, c, SEED), torch.bfloat16)
        with torch.no_grad():
            ys = ls.lstm_slab_fwd(*slab_args(a, ls, reverse))
            bargs = slab_args(a, ls, reverse, ys)
            fwd_ms = cuda_ms(lambda: ls.lstm_slab_fwd(
                *slab_args(a, ls, reverse)), 20)
            bwd_ms = cuda_ms(lambda: ls.lstm_slab_bwd(*bargs), 20)
            fwd_plain = cuda_ms(lambda: ls.lstm_slab_fwd_ref(
                *slab_args(a, ls, reverse)), 1)
            bwd_plain = cuda_ms(lambda: ls.lstm_slab_bwd_ref(*bargs), 1)
            split = profile_split(lambda: ls.lstm_slab_bwd(*bargs))
        lib_fwd, lib_bwd = cudnn_lstm_ms(dev, a, 10, torch.bfloat16)
        (fb, fby), ff, fbytes = slab_bound_ms(t_len, r, c, SLAB_H, "fwd",
                                              xb=2, wb=2)
        (bb, bby), bf, bbytes = slab_bound_ms(t_len, r, c, SLAB_H, "bwd",
                                              xb=2, wb=2)
        rows[name] = {"fwd": (fwd_ms, fwd_plain, fb, fby, lib_fwd),
                      "bwd": (bwd_ms, bwd_plain, bb, bby, lib_bwd)}
        log(f"  mixed {name} [T={t_len}, R={r}, C={c}] on {card}: fwd "
            f"{fwd_ms:.4f} ms (plain {fwd_plain:.2f}, cuDNN bf16 LSTM fwd "
            f"{lib_fwd:.4f}, bound {fb:.6f} {fby}: {ff} FLOP, {fbytes} B); "
            f"bwd {bwd_ms:.4f} ms (plain {bwd_plain:.2f}, cuDNN bf16 LSTM "
            f"bwd {lib_bwd:.4f}, bound {bb:.6f} {bby}: {bf} FLOP, "
            f"{bbytes} B); torch.profiler split of one backward call, "
            f"device us: {split}")
    total = sum(k for _, k in SLAB_MIX)
    mixed = {}
    for kind in ("fwd", "bwd"):
        vals = [sum(rows[name][kind][i] * k for name, k in SLAB_MIX) / total
                for i in (0, 1, 2, 4)]
        mixed[kind] = dict(zip(("ms", "plain_ms", "bound_ms", "library_ms"),
                               vals), bound_by=rows["intra"][kind][3])
    return mixed, rows


def bf16_module(args, init_ckpt, dev):
    """The flagship PLModule from init_ckpt with the bf16 trunk, as the
    campaign trainer runs it (float32 master params)."""
    from sound_bubble_tpu_torch.train.module import PLModule

    mod = PLModule(**{**args, "init_ckpt": init_ckpt}, device=dev)
    mod.set_bf16_trunk()
    return mod


def phase14_bf16_step(dev, ls):
    """One bf16 flagship step as train_stream takes it (cast_bf16, the bf16
    trunk) on phase 7's golden batch: the kernel path against the plain
    path on the card and against the JAX package's golden. Returns the
    kernel path's mixed launches (forward, backward) in the step."""
    from sound_bubble_tpu_torch import train_stream
    from sound_bubble_tpu_torch.data.synth import golden_batch

    with open(TRAIN_CONFIG) as fh:
        args = json.load(fh)["pl_module_args"]
    n_scans = 3 * args["model_params"]["B"]
    batch = golden_batch(SEED)
    flagship = os.path.join(RUN_DIR, "checkpoints", "best.pt")

    def one_step(plain):
        mod = bf16_module(args, flagship, dev)
        model_in = mod._model_inputs(batch[0])
        gt = torch.from_numpy(batch[1]["target"]).to(dev)
        before = mixed_counts(ls)
        with plain_slab(ls) if plain else contextlib.nullcontext():
            loss, _ = train_stream.train_step(mod, model_in, gt, True)
        torch.cuda.synchronize()
        grew = tuple(n - m for n, m in zip(mixed_counts(ls), before))
        return float(loss), float(mod.last_grad_norm), grew

    loss_k, norm_k, grew_k = one_step(False)
    loss_p, norm_p, grew_p = one_step(True)
    with open(BF16_STEP_GOLDEN) as fh:
        golden = json.load(fh)
    rel = {"plain loss": abs(loss_k - loss_p) / abs(loss_p),
           "plain norm": abs(norm_k - norm_p) / norm_p,
           "golden loss": abs(loss_k - golden["loss"]) / abs(golden["loss"]),
           "golden norm": abs(norm_k - golden["grad_norm"])
           / golden["grad_norm"]}
    log(f"phase 14 bf16 step (train_stream.train_step, cast_bf16, bf16 "
        f"trunk) from {os.path.relpath(flagship, REPO)} on the golden batch:"
        f" loss {loss_k:.6f}, pre-clip grad norm {norm_k:.6f}; plain path "
        f"on the card {loss_p:.6f}, {norm_p:.6f} (rel {rel['plain loss']:.2e},"
        f" {rel['plain norm']:.2e}); JAX golden "
        f"({os.path.basename(BF16_STEP_GOLDEN)}) {golden['loss']:.6f}, "
        f"{golden['grad_norm']:.6f} (rel {rel['golden loss']:.2e}, "
        f"{rel['golden norm']:.2e}; tol {BF16_LOSS_REL_TOL}, "
        f"{BF16_NORM_REL_TOL}); slab launches fp32 {grew_k[:2]}, mixed "
        f"{grew_k[2:]} (plain path {grew_p})")
    if grew_k != (0, 0, n_scans, n_scans) or grew_p != (0, 0, 0, 0):
        fail(f"bf16 step launches: kernel path {grew_k}, plain path {grew_p};"
             f" expected fp32 (0, 0) and mixed ({n_scans}, {n_scans}), and "
             f"none")
    for what in ("plain", "golden"):
        if not (rel[f"{what} loss"] <= BF16_LOSS_REL_TOL
                and rel[f"{what} norm"] <= BF16_NORM_REL_TOL):
            fail(f"the bf16 step disagrees with the {what} reference: {rel}")
    return grew_k[2:]


def bf16_step_times(dev, ls, mixed_rows, card):
    """ms per bf16 train step at the recipe (batch 8 x 2.5 s: golden
    batches 0 and 1), host clock over 5 steps after one warm-up, peak device
    memory, and the step's split: 12 intra + 6 inter launches of each mixed
    slab kernel at their per-launch times, the eager rest by difference."""
    from sound_bubble_tpu_torch import train_stream
    from sound_bubble_tpu_torch.data.synth import golden_batch

    with open(TRAIN_CONFIG) as fh:
        args = json.load(fh)["pl_module_args"]
    mod = bf16_module(args, os.path.join(RUN_DIR, "checkpoints", "best.pt"),
                      dev)
    b0, b1 = golden_batch(SEED), golden_batch(SEED + 1)
    inputs = {k: np.concatenate([b0[0][k], b1[0][k]]) for k in b0[0]
              if k in ("mixture", "dis_embed")}
    model_in = mod._model_inputs(inputs)
    gt = torch.from_numpy(np.concatenate([b0[1]["target"],
                                          b1[1]["target"]])).to(dev)
    train_stream.train_step(mod, model_in, gt, True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(5):
        train_stream.train_step(mod, model_in, gt, True)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) / 5 * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fwd_ms, bwd_ms = (sum(k * mixed_rows[name][kind][0]
                          for name, k in SLAB_MIX) for kind in ("fwd", "bwd"))
    slab_ms = fwd_ms + bwd_ms
    log(f"phase 14 times on {card}: bf16 train step {step_ms:.2f} ms "
        f"(train_stream.train_step, batch 8 x 2.5 s, host clock, 5 steps), "
        f"peak device memory {peak_gb:.2f} GB; mixed slab launches 12 intra "
        f"+ 6 inter of each kernel: {slab_ms:.2f} ms (forward {fwd_ms:.2f}, "
        f"backward {bwd_ms:.2f}); the eager rest by difference "
        f"{step_ms - slab_ms:.2f} ms")
    return step_ms


def phase15_train_stream(dev, ls, card):
    """`python -m sound_bubble_tpu_torch.train_stream` with the flagship
    recipe's arguments (runs/finetune_r5/train_stream_args.json) from the
    flagship checkpoint, the pool and the steps cut (STREAM_CUTS); then a
    --resume. Returns the main run's mixed launches (forward, backward)."""
    from sound_bubble_tpu_torch import train_stream
    from sound_bubble_tpu_torch.datagen import campaign
    from sound_bubble_tpu_torch.train.checkpoint import load_checkpoint

    with open(os.path.join(RUN_DIR, "train_stream_args.json")) as fh:
        recipe = json.load(fh)
    with open(os.path.join(RUN_DIR, "config.json")) as fh:
        cfg = json.load(fh)
    cfg["pl_module_args"]["init_ckpt"] = os.path.join(
        RUN_DIR, "checkpoints", "best.pt")
    n_scans = 3 * cfg["pl_module_args"]["model_params"]["B"]
    built = []
    build_pool = campaign.build_pool

    def timed_build(*a, **k):
        t = time.perf_counter()
        out = build_pool(*a, **k)
        built.append(time.perf_counter() - t)
        return out

    tmp = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    campaign.build_pool = timed_build
    try:
        cfg_path, run_dir = (os.path.join(tmp, "config.json"),
                             os.path.join(tmp, "run"))
        with open(cfg_path, "w") as fh:
            json.dump(cfg, fh)
        argv = ["--config", cfg_path, "--run_dir", run_dir,
                "--bf16" if recipe["bf16"] else "--no-bf16",
                "--voice", recipe["voice"], "--batch", str(recipe["batch"]),
                "--clip_seconds", str(recipe["clip_seconds"]),
                "--snr_min", str(recipe["snr_range"][0]),
                "--snr_max", str(recipe["snr_range"][1]),
                "--bg_noise", str(recipe["bg_noise"]), "--seed", str(SEED),
                *STREAM_CUTS]
        steps, val_every = STREAM_STEPS
        # ---- the main path: the campaign's first steps and validation
        ls.lstm_slab_fwd.launches = ls.lstm_slab_bwd.launches = 0
        ls.lstm_slab_fwd.mixed_launches = ls.lstm_slab_bwd.mixed_launches = 0
        t = time.perf_counter()
        mod = train_stream.main(train_stream.parse_args(
            argv + ["--steps", str(steps), "--val_every", str(val_every)]))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        counts = mixed_counts(ls)
        want = (0, 0, (steps + 1) * n_scans, steps * n_scans)
        with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
            logged = [json.loads(line) for line in fh]
        log(f"phase 15 train_stream: the flagship recipe {recipe} from "
            f"runs/finetune_r5/checkpoints/best.pt, cut to "
            f"{' '.join(STREAM_CUTS)} --steps {steps} --val_every "
            f"{val_every}: {run_s:.2f} s incl. the pool build "
            f"({', '.join('%.2f s' % s for s in built)} for the train and "
            f"validation pools); slab launches fp32 {counts[:2]}, mixed "
            f"{counts[2:]} (expected {want[2:]}: {n_scans} per step, "
            f"{n_scans} forward for the validation batch); log {logged}")
        if counts != want:
            fail(f"train_stream slab launches {counts}, expected {want}")
        last = load_checkpoint(os.path.join(run_dir, "checkpoints",
                                            "last.pt"))
        vals = [r["val_loss"] for r in logged if "val_loss" in r]
        if (last["current_epoch"] != 1 or len(vals) != 1
                or not np.isfinite(vals).all()
                or not os.path.exists(os.path.join(run_dir, "checkpoints",
                                                   "best.pt"))):
            fail(f"train_stream run: epoch {last['current_epoch']}, "
                 f"validations {vals}")
        if mod.net.cfg.compute_dtype != "bf16":
            fail("train_stream did not run the bf16 trunk")

        # ---- resume from last.pt with the other precision flag
        before = mixed_counts(ls)
        argv[argv.index("--bf16")] = "--no-bf16"
        mod = train_stream.main(train_stream.parse_args(
            argv + ["--steps", str(steps + 2), "--val_every",
                    str(val_every), "--resume"]))
        torch.cuda.synchronize()
        grew = tuple(n - m for n, m in zip(mixed_counts(ls), before))
        last = load_checkpoint(os.path.join(run_dir, "checkpoints",
                                            "last.pt"))
        with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
            steps_logged = [json.loads(line)["step"] for line in fh]
        log(f"  resumed with --no-bf16 from last.pt at step {steps}: the "
            f"recorded bf16 kept ({mod.net.cfg.compute_dtype}); slab "
            f"launches fp32 {grew[:2]}, mixed {grew[2:]}; steps logged "
            f"{steps_logged}")
        if (mod.net.cfg.compute_dtype != "bf16"
                or grew != (0, 0, 3 * n_scans, 2 * n_scans)
                or steps_logged[len(logged):] != [steps + 2, steps + 2]):
            fail("the resumed train_stream run did not continue in bf16 "
                 "for exactly two steps and one validation")
    finally:
        campaign.build_pool = build_pool
        shutil.rmtree(tmp, ignore_errors=True)
    return counts[2:], sum(built)


def seeded_net(model_params, conditional, seed):
    """The port's Net with weights drawn from `seed` (the JAX package's
    initial distributions)."""
    from sound_bubble_tpu_torch.models.tfgridnet.model import Net, make_config

    net = Net(make_config(model_params, conditional=conditional))
    return net.init_weights(torch.Generator().manual_seed(seed))


def phase9_conv_kernel(dev, edge_net):
    """The conv kernel against its plain version, 5 chained steps, at the
    Orange Pi width (committed seeded weights), the Raspberry Pi width and a
    ragged F with FiLM. Returns the max-abs error."""
    from sound_bubble_tpu_torch.ops.kernels import stack_kernel as sk
    from sound_bubble_tpu_torch.weights import param_tree

    with open(EDGE_CONFIG.format("raspberrypi", "finetune")) as fh:
        rpi = json.load(fh)["pl_module_args"]["model_params"]
    ragged = dict(stft_chunk_size=32, stft_pad_size=16, D=8, B=3, H=8,
                  conv_lstm=True, lstm_down=4)       # F = 25, k*s = 24
    cases = (("orangepi", edge_net, False),
             ("raspberrypi", seeded_net(rpi, False, SEED), False),
             ("ragged", seeded_net(ragged, True, SEED), True))
    rng = np.random.default_rng(SEED + 9)
    worst = 0.0
    for name, net, film in cases:
        cfg = net.cfg
        F, D, H, B = cfg.n_freqs, cfg.D, cfg.H, cfg.B
        packed = {k: v.to(dev) for k, v in sk.pack_stack_params(
            cfg, param_tree(net)).items()}

        def draw(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32)).to(dev)

        fw, fb = ((draw(B - 1, F, D), draw(B - 1, F, D)) if film
                  else (None, None))
        hk, ck = draw(B, F, H) * 0.5, draw(B, F, H) * 0.5
        hr, cr = hk, ck
        before = sk.gridnet_stack_step.conv_launches
        err = 0.0
        with torch.no_grad():
            for _ in range(5):
                x = draw(F, D)
                xk, hk, ck = sk.gridnet_stack_step(packed, x, hk, ck, fw, fb,
                                                   eps=cfg.eps)
                xr, hr, cr = sk.gridnet_stack_step_ref(packed, x, hr, cr, fw,
                                                       fb, eps=cfg.eps)
                torch.cuda.synchronize()
                err = max(err, *[float((a - b).abs().max())
                                 for a, b in ((xk, xr), (hk, hr), (ck, cr))])
        grew = sk.gridnet_stack_step.conv_launches - before
        plan = sk.conv_walk_plan(F, D, H, B, cfg.lstm_down)
        log(f"  {name}: F={F} D={D} H={H} B={B} s={cfg.lstm_down} (k*s = "
            f"{F // cfg.lstm_down * cfg.lstm_down}), FiLM {film}, 5 chained "
            f"steps, max-abs err {err:.3e} (tol {KERNEL_TOL}), conv kernel "
            f"launches +{grew}; launch {plan}")
        if not err <= KERNEL_TOL:
            fail(f"conv kernel disagrees with its plain version at {name}: "
                 f"{err} > {KERNEL_TOL}")
        if grew != 5:
            fail(f"conv kernel launches grew by {grew} at {name}, expected 5")
        worst = max(worst, err)
    log(f"phase 9 conv kernel vs plain: max-abs err {worst:.3e}")
    return worst


def phase10_edge_serving(dev, streamer):
    """The 9 goldens through FusedStreamer on the seeded edge weights, by the
    serving CLI's code path, against the JAX package's numbers; the first 20
    chunks against the JAX output; kernel path vs ModelWrapper. Returns the
    conv kernel's launches on the main path and the chunk count."""
    from sound_bubble_tpu_torch import test_samples
    from sound_bubble_tpu_torch.evaluation import load_testcase, run_testcase
    from sound_bubble_tpu_torch.ops.kernels import stack_kernel as sk
    from sound_bubble_tpu_torch.ops.stft import mod_pad
    from sound_bubble_tpu_torch.runtime.streaming import (
        ModelWrapper, streaming_inference)

    cfg = streamer.cfg
    with open(EDGE_GOLDENS) as fh:
        golden = json.load(fh)
    n_chunks, failures, results = 0, [], {}
    sk.gridnet_stack_step.conv_launches = 0
    t = time.perf_counter()
    for radius, threshold in RADII:
        rdir = os.path.join(GOLDENS, f"syn_{radius}")
        sisdris, _, decays = test_samples.evaluate_dir(
            streamer, rdir, threshold, verbose=False)
        want = {"sisdri": [], "decay": []}
        for name in sorted(os.listdir(rdir)):
            (key, v), = golden["samples"][f"{radius}/{name}"].items()
            want[key].append(v)
            _, mixture, _, _, _ = load_testcase(os.path.join(rdir, name),
                                                24000, threshold)
            n_chunks += -(-mixture.shape[-1] // cfg.stft_chunk_size)
        for key, got in (("sisdri", sisdris), ("decay", decays)):
            if len(got) != len(want[key]) or not np.isfinite(got).all():
                fail(f"edge {radius}: {key} {got} vs JAX {want[key]}")
            for g, w in zip(got, want[key]):
                if not abs(g - w) <= PARITY_TOL_DB:
                    failures.append(f"edge {radius} {key} {g:.5f} vs JAX "
                                    f"{w:.5f} (tol {PARITY_TOL_DB} dB)")
        results[radius] = (sisdris, decays)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    launches = sk.gridnet_stack_step.conv_launches
    log(f"phase 10 edge serving: 9 goldens, {n_chunks} chunks in "
        f"{serve_s:.2f} s ({serve_s / n_chunks * 1e3:.3f} ms/chunk incl. "
        f"metrics), conv kernel launches {launches}")
    for radius, (sisdris, decays) in results.items():
        log(f"  edge goldens {radius}: SI-SDRi {np.round(sisdris, 4)} (JAX "
            f"mean {golden['sisdri'][radius]:+.4f}), decay "
            f"{np.round(decays, 4)} (JAX mean {golden['decay'][radius]:.4f})")
    if failures:
        fail("edge goldens: " + "; ".join(failures))
    if launches != n_chunks:
        fail(f"conv kernel launched {launches} times for {n_chunks} chunks")

    head = golden["head"]
    _, mixture, _, _, _ = load_testcase(
        os.path.join(GOLDENS, head["sample"]), 24000, 1.0)
    # the head chunks and their lookahead: the streamed output's first
    # n_head samples are those of the whole clip
    n_head = head["chunks"] * cfg.stft_chunk_size
    clip = mixture[:, :n_head + cfg.stft_pad_size]
    fused = run_testcase(streamer, clip)
    want = np.asarray(head["output"], np.float32)
    rel_jax = float(np.abs(fused[0, :n_head] - want).max()
                    / np.abs(want).max())
    xp, mod = mod_pad(torch.from_numpy(clip)[None], cfg.stft_chunk_size,
                      (cfg.stft_back_pad, cfg.stft_pad_size))
    plain = streaming_inference(ModelWrapper(streamer.net, device=dev), xp,
                                cfg.stft_chunk_size,
                                cfg.stft_pad_size)[0].cpu().numpy()
    plain = plain[..., :-mod] if mod else plain
    rel = float(np.abs(fused - plain).max() / np.abs(plain).max())
    log(f"  first {head['chunks']} chunks of {head['sample']}: vs the JAX "
        f"output max-abs / peak {rel_jax:.3e} (tol {EDGE_HEAD_REL_TOL}); "
        f"kernel path vs ModelWrapper {rel:.3e} (tol {STREAM_REL_TOL})")
    if not rel_jax <= EDGE_HEAD_REL_TOL:
        fail(f"edge stream disagrees with the JAX output: {rel_jax}")
    if not rel <= STREAM_REL_TOL:
        fail(f"edge streaming paths disagree: {rel} > {STREAM_REL_TOL}")
    return launches, n_chunks


def phase11_edge_train(dev, ls):
    """train_pt on the Orange Pi pretrain config, then on the finetune config
    from the pretrain's last.pt; one finetune step from the seeded weights,
    kernel path against plain path and against the JAX golden. Returns the
    module of that step and its batch."""
    from sound_bubble_tpu_torch.data.synth import (
        golden_batch, write_sample_dirs)
    from sound_bubble_tpu_torch.train.checkpoint import load_checkpoint

    tmp = tempfile.mkdtemp(prefix="chip_smoke_edge_")
    try:
        n_train, n_val = 4, 2
        dirs = write_sample_dirs(os.path.join(tmp, "data"), SEED + 1,
                                 n_train, n_val)
        last = None
        for stage in ("pretrain", "finetune"):
            with open(EDGE_CONFIG.format("orangpi", stage)) as fh:
                cfg = json.load(fh)
            args = cfg["pl_module_args"]
            n_scans = 3 * args["model_params"]["B"]
            point_at_scenes(cfg, dirs)
            cfg["num_workers"] = 2
            if stage == "finetune":
                args["init_ckpt"] = last       # the recipe's chain
            run_dir = os.path.join(tmp, stage)
            hl, secs, fwd_n, bwd_n = run_train_pt(
                cfg, os.path.join(tmp, f"{stage}.json"), run_dir, 1, ls)
            steps = math.ceil(3 * n_train / cfg["batch_size"])
            val_batches = math.ceil(3 * n_val / cfg["eval_batch_size"])
            want = ((steps + val_batches) * n_scans, steps * n_scans)
            last = os.path.join(run_dir, "checkpoints", "last.pt")
            state = load_checkpoint(last)
            losses = [state["metric_values"][0][k]["epoch"]
                      / state["metric_values"][0][k]["num_elements"]
                      for k in ("train/loss", "val/loss")]
            log(f"phase 11 edge training, {stage} "
                f"({os.path.basename(EDGE_CONFIG.format('orangpi', stage))}"
                f", {args['loss'].rsplit('.', 1)[1]}): 1 epoch x {steps} "
                f"steps + {val_batches} val batch(es) in {secs:.2f} s; slab "
                f"launches fwd {fwd_n}, bwd {bwd_n} (expected {want[0]}, "
                f"{want[1]}: {n_scans} per step); epoch losses (train, val) "
                f"{losses}")
            if (fwd_n, bwd_n) != want:
                fail(f"edge {stage}: slab launches {(fwd_n, bwd_n)}, "
                     f"expected {want}")
            if state["current_epoch"] != 1 or not np.isfinite(losses).all():
                fail(f"edge {stage}: last.pt {state['current_epoch']}, "
                     f"losses {losses}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # one finetune step from the seeded weights on the golden batch: kernel
    # path, plain path, JAX golden
    with open(EDGE_CONFIG.format("orangpi", "finetune")) as fh:
        args = json.load(fh)["pl_module_args"]
    batch = golden_batch(SEED)
    mod, loss, norm, grads = kernel_vs_plain_step(
        args, os.path.join(EDGE_RUN_DIR, "checkpoints", "best.pt"), batch,
        3 * args["model_params"]["B"], dev, ls)
    check_step_golden(loss, norm, grads, args["grad_clip"], EDGE_STEP_GOLDEN)
    return mod, batch


def phase12_edge_times(dev, streamer, mod, batch, card, ls):
    """Times of the conv kernel, its plain version, one edge chunk, one
    edge train step and the slab kernels at the edge step's shapes."""
    from sound_bubble_tpu_torch.ops.kernels import stack_kernel as sk
    from tools.time_stack_kernels import graph_ms

    cfg = streamer.cfg
    F, D, H, B = cfg.n_freqs, cfg.D, cfg.H, cfg.B
    rng = np.random.default_rng(SEED + 12)

    def draw(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    x, h0, c0 = draw(F, D), draw(B, F, H) * 0.5, draw(B, F, H) * 0.5
    packed = streamer.packed
    with torch.no_grad():
        def kernel():
            sk.gridnet_stack_step(packed, x, h0, c0, eps=cfg.eps,
                                  checked=True)

        def plain_step():
            sk.gridnet_stack_step_ref(packed, x, h0, c0, eps=cfg.eps)

        for _ in range(10):
            kernel()
        kernel_ms = cuda_ms(kernel, 200)
        plain_step()
        plain_ms = cuda_ms(plain_step, 3)
        kernel_graph_ms = graph_ms(kernel, 20)
        if kernel_graph_ms is None:
            fail("the conv kernel's call could not be captured in a CUDA "
                 "graph")
        streamer.reset()
        win = torch.from_numpy(rng.standard_normal(
            (1, cfg.num_ch, cfg.n_fft)).astype(np.float32))
        for _ in range(10):
            streamer.feed(win)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(250):
            streamer.feed(win)
        torch.cuda.synchronize()
        chunk_ms = (time.perf_counter() - t) / 250 * 1e3
    bound_ms, bound_by = stack_step_bound_ms(B, F, D, H, False,
                                             s=cfg.lstm_down)
    step_ms, peak_gb = train_step_ms(mod, batch, dev)
    # the slab kernels at the edge step's shapes: 6 intra and 3 inter
    # launches of each a step
    shapes = {name: rest for name, *rest in SLAB_SHAPES}
    slab = {}
    for name in ("edge_intra", "edge_inter"):
        t_len, r, c, reverse = shapes[name]
        a = slab_case(dev, t_len, r, c, SEED)
        with torch.no_grad():
            ys = ls.lstm_slab_fwd(*slab_args(a, ls, reverse))
            bargs = slab_args(a, ls, reverse, ys)
            slab[name] = (cuda_ms(lambda: ls.lstm_slab_fwd(
                *slab_args(a, ls, reverse)), 20),
                cuda_ms(lambda: ls.lstm_slab_bwd(*bargs), 20))
    in_step = sum(n * sum(slab[name]) for name, n in (("edge_intra", 6),
                                                      ("edge_inter", 3)))
    log("  edge slab launches (CUDA events, 20 launches): " + "; ".join(
        f"{name} {list(shapes[name][:3])} fwd {slab[name][0]:.4f} ms, bwd "
        f"{slab[name][1]:.4f} ms" for name in slab)
        + f"; 6 intra + 3 inter of each a step: {in_step:.2f} ms")
    log(f"phase 12 edge times on {card}: conv kernel {kernel_ms:.4f} ms "
        f"(CUDA events, 200 launches; {kernel_graph_ms:.4f} ms a call as 20 "
        f"calls in one CUDA graph); plain version {plain_ms:.3f} ms (3 "
        f"calls); FusedStreamer.feed (graphed) {chunk_ms:.4f} ms per 8 ms "
        f"chunk (host "
        f"clock, 250 chunks); bound {bound_ms:.6f} ms ({bound_by}); "
        f"library_ms: none (no single PyTorch call computes the stack "
        f"step); edge train step {step_ms:.2f} ms (finetune, batch 4 x "
        f"2.5 s, host clock, 5 steps), peak device memory {peak_gb:.2f} GB")
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def attn_case(net, dev):
    """(a FusedStreamer of an attention net with the 1 m embedding, whose
    packs and FiLM the kernel takes; empty K/V rings) on the card."""
    from sound_bubble_tpu_torch.evaluation import one_hot
    from sound_bubble_tpu_torch.runtime.fast_path import FusedStreamer

    streamer = FusedStreamer(net, dis_embed=one_hot(1.0), device=dev)
    cfg = net.cfg
    F, W = cfg.n_freqs, cfg.local_atten_len
    rings = (torch.zeros((cfg.B, cfg.L * cfg.E, W, F), device=dev),
             torch.zeros((cfg.B, cfg.D, W, F), device=dev))
    return streamer, rings


def phase16_attn_kernels(dev, nets):
    """The two attention kernels against their plain version, W + 5
    chained steps from zero rings at both nets' widths (flagship with FiLM).
    Returns {net: max-abs error}."""
    from sound_bubble_tpu_torch.ops.kernels import stack_kernel as sk

    errs = {}
    rng = np.random.default_rng(SEED + 16)
    for name, net in nets.items():
        cfg = net.cfg
        F, D, H, B, W = cfg.n_freqs, cfg.D, cfg.H, cfg.B, cfg.local_atten_len
        streamer, (kk, vk) = attn_case(net, dev)
        packed, pa = streamer.packed, streamer.packed_attn
        fw, fb = streamer.film if streamer.film is not None else (None, None)

        def draw(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32)).to(dev)

        hk, ck = draw(B, F, H) * 0.5, draw(B, F, H) * 0.5
        hr, cr, kr, vr = hk, ck, kk.clone(), vk.clone()
        counter = ("conv_attn_launches" if cfg.conv_lstm
                   else "attn_launches")
        before = getattr(sk.gridnet_stack_step, counter)
        err = {k: 0.0 for k in ("x", "h0", "c0", "k_ring", "v_ring")}
        with torch.no_grad():
            for step in range(W + 5):
                x = draw(F, D)
                xk, hk, ck, kk, vk = sk.gridnet_stack_step_attn(
                    packed, pa, x, hk, ck, kk, vk,
                    torch.tensor([step % W], dtype=torch.int32, device=dev),
                    cfg.L, fw, fb, eps=cfg.eps)
                xr, hr, cr, kr, vr = sk.gridnet_stack_step_attn_ref(
                    packed, pa, x, hr, cr, kr, vr, step % W, cfg.L, fw, fb,
                    eps=cfg.eps)
                torch.cuda.synchronize()
                for key, a, b in (("x", xk, xr), ("h0", hk, hr),
                                  ("c0", ck, cr), ("k_ring", kk, kr),
                                  ("v_ring", vk, vr)):
                    err[key] = max(err[key], float((a - b).abs().max()))
        grew = getattr(sk.gridnet_stack_step, counter) - before
        worst = max(err.values())
        log(f"  {name}: F={F} D={D} H={H} B={B} L={cfg.L} E={cfg.E} W={W} "
            f"conv_lstm={cfg.conv_lstm}, FiLM {fw is not None}, {W + 5} "
            f"chained steps (pos wraps): max-abs err "
            + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
            + f" (tol {KERNEL_TOL}); {counter} +{grew}")
        if not worst <= KERNEL_TOL:
            fail(f"attention kernel disagrees with its plain version at "
                 f"{name}: {err}")
        if grew != W + 5:
            fail(f"{counter} grew by {grew}, expected {W + 5}")
        errs[name] = worst
    log(f"phase 16 attention kernels vs plain: max-abs err {errs}")
    return errs


def phase17_attn_serving(dev, nets):
    """Both attention nets through FusedStreamer (in-kernel) over the 9
    goldens against the JAX numbers; the first 20 chunks against the JAX
    output; the per-block route against the in-kernel route on one clip.
    Returns {net: (streamer, launches on the goldens)}."""
    from sound_bubble_tpu_torch import test_samples
    from sound_bubble_tpu_torch.evaluation import (
        load_testcase, one_hot, run_testcase)
    from sound_bubble_tpu_torch.ops.kernels import stack_kernel as sk
    from sound_bubble_tpu_torch.runtime.fast_path import FusedStreamer

    with open(ATTN_GOLDENS) as fh:
        goldens = json.load(fh)
    out = {}
    for name, net in nets.items():
        cfg = net.cfg
        golden = goldens[name]
        counter = ("conv_attn_launches" if cfg.conv_lstm
                   else "attn_launches")
        streamer = FusedStreamer(net, device=dev)
        n_chunks, failures, results = 0, [], {}
        # the main path: only the attention kernel of this net launches
        for c in ("launches", "conv_launches", "attn_launches",
                  "conv_attn_launches"):
            setattr(sk.gridnet_stack_step, c, 0)
        t = time.perf_counter()
        for radius, threshold in RADII:
            rdir = os.path.join(GOLDENS, f"syn_{radius}")
            sisdris, _, decays = test_samples.evaluate_dir(
                streamer, rdir, threshold, verbose=False)
            want = {"sisdri": [], "decay": []}
            for sample in sorted(os.listdir(rdir)):
                (key, v), = golden["samples"][f"{radius}/{sample}"].items()
                want[key].append(v)
                _, mixture, _, _, _ = load_testcase(
                    os.path.join(rdir, sample), 24000, threshold)
                n_chunks += -(-mixture.shape[-1] // cfg.stft_chunk_size)
            for key, got in (("sisdri", sisdris), ("decay", decays)):
                if len(got) != len(want[key]) or not np.isfinite(got).all():
                    fail(f"attn {name} {radius}: {key} {got} vs JAX "
                         f"{want[key]}")
                for g, w in zip(got, want[key]):
                    if not abs(g - w) <= PARITY_TOL_DB:
                        failures.append(f"attn {name} {radius} {key} "
                                        f"{g:.5f} vs JAX {w:.5f}")
            results[radius] = (sisdris, decays)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t
        launches = {c: getattr(sk.gridnet_stack_step, c) for c in (
            "launches", "conv_launches", "attn_launches",
            "conv_attn_launches")}
        log(f"phase 17 attention serving, {name}: 9 goldens, {n_chunks} "
            f"chunks in {serve_s:.2f} s ({serve_s / n_chunks * 1e3:.3f} "
            f"ms/chunk incl. metrics), stack kernel launches {launches}")
        for radius, (sisdris, decays) in results.items():
            log(f"  {name} goldens {radius}: SI-SDRi {np.round(sisdris, 4)}"
                f" (JAX mean {golden['sisdri'][radius]:+.4f}), decay "
                f"{np.round(decays, 4)} (JAX mean "
                f"{golden['decay'][radius]:.4f})")
        if failures:
            fail(f"attention goldens (tol {PARITY_TOL_DB} dB): "
                 + "; ".join(failures))
        if launches != {c: n_chunks if c == counter else 0
                        for c in launches}:
            fail(f"{name}: kernel launches {launches} for {n_chunks} "
                 f"chunks, expected {counter} only")

        head = golden["head"]
        _, mixture, _, _, _ = load_testcase(
            os.path.join(GOLDENS, head["sample"]), 24000, 1.0)
        n_head = head["chunks"] * cfg.stft_chunk_size
        fused = run_testcase(streamer, mixture[:, :n_head + cfg.stft_pad_size],
                             1.0)
        want = np.asarray(head["output"], np.float32)
        rel_jax = float(np.abs(fused[0, :n_head] - want).max()
                        / np.abs(want).max())
        # the per-block route on the whole clip against the in-kernel one
        whole = run_testcase(streamer, mixture, 1.0)
        per_block = FusedStreamer(net, dis_embed=one_hot(1.0), device=dev,
                                  attn_in_kernel=False)
        b0 = sk.gridnet_stack_step.launches + sk.gridnet_stack_step.conv_launches
        routed = run_testcase(per_block, mixture, 1.0)
        per_block_launches = (sk.gridnet_stack_step.launches
                              + sk.gridnet_stack_step.conv_launches - b0)
        rel = float(np.abs(whole - routed).max() / np.abs(routed).max())
        clip_chunks = -(-mixture.shape[-1] // cfg.stft_chunk_size)
        log(f"  {name} first {head['chunks']} chunks of {head['sample']}: "
            f"vs the JAX output max-abs / peak {rel_jax:.3e} (tol "
            f"{EDGE_HEAD_REL_TOL}); the whole clip, in-kernel route vs "
            f"per-block route ({per_block_launches} row-1/2 launches, "
            f"{cfg.B} a chunk): max-abs / peak {rel:.3e} (tol "
            f"{STREAM_REL_TOL})")
        if not rel_jax <= EDGE_HEAD_REL_TOL:
            fail(f"attention stream of {name} disagrees with the JAX "
                 f"output: {rel_jax}")
        if not rel <= STREAM_REL_TOL:
            fail(f"{name}: the two FusedStreamer routes disagree: {rel}")
        if per_block_launches != cfg.B * clip_chunks:
            fail(f"{name}: the per-block route launched "
                 f"{per_block_launches} times for {clip_chunks} chunks")
        out[name] = (streamer, per_block, launches[counter])
    return out


def feed_ms(streamer, n, rng):
    """ms per FusedStreamer.feed, host clock, n chunks after 10."""
    cfg = streamer.cfg
    streamer.reset()
    win = torch.from_numpy(rng.standard_normal(
        (1, cfg.num_ch, cfg.n_fft)).astype(np.float32))
    with torch.no_grad():
        for _ in range(10):
            streamer.feed(win)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            streamer.feed(win)
        torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e3


def phase18_attn_times(dev, served, card):
    """Times of the two attention kernels (CUDA events; and 20 calls in one
    CUDA graph, the device's time), their plain versions, their bounds, and
    ms per chunk on both routes."""
    from sound_bubble_tpu_torch.ops.kernels import stack_kernel as sk
    from tools.time_stack_kernels import graph_ms

    rng = np.random.default_rng(SEED + 18)
    rows = {}
    for name, (streamer, per_block, _) in served.items():
        cfg = streamer.cfg
        F, D, H, B, W = cfg.n_freqs, cfg.D, cfg.H, cfg.B, cfg.local_atten_len

        def draw(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32)).to(dev)

        x, h0, c0 = draw(F, D), draw(B, F, H) * 0.5, draw(B, F, H) * 0.5
        kr = draw(B, cfg.L * cfg.E, W, F)
        vr = draw(B, D, W, F)
        fw, fb = streamer.film if streamer.film is not None else (None, None)
        # the kernel's work does not depend on the slot's value
        pos = torch.zeros((1,), dtype=torch.int32, device=dev)
        with torch.no_grad():
            def kernel():
                sk.gridnet_stack_step_attn(
                    streamer.packed, streamer.packed_attn, x, h0, c0, kr, vr,
                    pos, cfg.L, fw, fb, eps=cfg.eps, checked=True)

            def plain_step():
                sk.gridnet_stack_step_attn_ref(
                    streamer.packed, streamer.packed_attn, x, h0, c0, kr, vr,
                    0, cfg.L, fw, fb, eps=cfg.eps)

            for _ in range(10):
                kernel()
            kernel_ms = cuda_ms(kernel, 200)
            plain_step()
            plain_ms = cuda_ms(plain_step, 3)
        graph = graph_ms(kernel, 20)
        if graph is None:
            fail(f"{name}: the attention kernel's call could not be "
                 "captured in a CUDA graph")
        chunk_ms = feed_ms(streamer, 250, rng)
        block_ms = feed_ms(per_block, 100, rng)
        s = cfg.lstm_down if cfg.conv_lstm else None
        bound_ms, bound_by = stack_step_bound_ms(
            B, F, D, H, fw is not None, s=s, attn=(cfg.L, cfg.E, W))
        log(f"phase 18 attention times, {name}, on {card}: kernel "
            f"{kernel_ms:.4f} ms (CUDA events, 200 launches; "
            f"{graph:.4f} ms a call as 20 calls in one CUDA graph); plain "
            f"version "
            f"{plain_ms:.3f} ms (3 calls); FusedStreamer.feed (graphed) "
            f"{chunk_ms:.4f} ms per 8 ms chunk in-kernel (250 chunks), "
            f"{block_ms:.4f} ms per-block route (100 chunks; host clock, "
            f"a window copied in from the host a chunk); bound "
            f"{bound_ms:.6f} ms ({bound_by}); library_ms: none (no single "
            f"PyTorch call computes the stack step)")
        rows[name] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None)
    return rows


def phase19_attn_train(dev, ls, card):
    """train_pt on the attention flagship's config from its seeded weights,
    1 epoch; one step from the seeded weights, kernel path against plain
    path and against the JAX golden; ms per step, peak memory."""
    from sound_bubble_tpu_torch.data.synth import (
        golden_batch, write_sample_dirs)
    from sound_bubble_tpu_torch.train.checkpoint import load_checkpoint

    init_ckpt = os.path.join(ATTN_RUN_DIRS["flagship"], "checkpoints",
                             "best.pt")
    with open(os.path.join(ATTN_RUN_DIRS["flagship"], "config.json")) as fh:
        cfg = json.load(fh)
    args = cfg["pl_module_args"]
    args["init_ckpt"] = init_ckpt
    n_scans = 3 * args["model_params"]["B"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_attn_")
    try:
        n_train, n_val = 4, 2
        dirs = write_sample_dirs(os.path.join(tmp, "data"), SEED + 19,
                                 n_train, n_val)
        point_at_scenes(cfg, dirs)
        cfg["num_workers"] = 2
        run_dir = os.path.join(tmp, "run")
        _, secs, fwd_n, bwd_n = run_train_pt(
            cfg, os.path.join(tmp, "config.json"), run_dir, 1, ls)
        steps = math.ceil(3 * n_train / cfg["batch_size"])
        val_batches = math.ceil(3 * n_val / cfg["eval_batch_size"])
        want = ((steps + val_batches) * n_scans, steps * n_scans)
        state = load_checkpoint(os.path.join(run_dir, "checkpoints",
                                             "last.pt"))
        losses = [state["metric_values"][0][k]["epoch"]
                  / state["metric_values"][0][k]["num_elements"]
                  for k in ("train/loss", "val/loss")]
        log(f"phase 19 attention training: train_pt on "
            f"{os.path.relpath(ATTN_RUN_DIRS['flagship'], REPO)}/config.json"
            f" from its seeded weights, 1 epoch x {steps} steps + "
            f"{val_batches} val batch(es) in {secs:.2f} s; slab launches fwd "
            f"{fwd_n}, bwd {bwd_n} (expected {want[0]}, {want[1]}: "
            f"{n_scans} per step); epoch losses (train, val) {losses}")
        if (fwd_n, bwd_n) != want:
            fail(f"attention training: slab launches {(fwd_n, bwd_n)}, "
                 f"expected {want}")
        if state["current_epoch"] != 1 or not np.isfinite(losses).all():
            fail(f"attention training: last.pt {state['current_epoch']}, "
                 f"losses {losses}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    batch = golden_batch(SEED)
    mod, loss, norm, grads = kernel_vs_plain_step(
        args, init_ckpt, batch, n_scans, dev, ls)
    check_step_golden(loss, norm, grads, args["grad_clip"], ATTN_STEP_GOLDEN)
    step_ms, peak_gb = train_step_ms(mod, batch, dev)
    log(f"phase 19 attention times on {card}: train step {step_ms:.2f} ms "
        f"(PLModule.train_step, fp32, batch 4 x 2.5 s, host clock, 5 "
        f"steps), peak device memory {peak_gb:.2f} GB")


# ---- phases 20-24: the custom-VJP kernel route (`--lstm_scan seq`, rows
# 6-9: `ops/kernels/lstm_train_kernel.py`, `csrc/lstm_seq.cu`,
# `csrc/lstm_seq_fwd_mixed.cu`, `csrc/lstm_seq_bwd.cu`)

# (name, T, R, C, directions): the route's recurrences at the flagship
# training path's shapes (batch 4 x 2.5 s: the intra BLSTM [145, 1252, 32],
# both directions in one walk, rows 8-9; the inter LSTM [313, 580, 32], rows
# 6-7) and a ragged R (37 rows: one row a block, the last rows' tails)
SEQ_SHAPES = (("intra", 145, 1252, 32, 2), ("inter", 313, 580, 32, 1),
              ("ragged_bi", 13, 37, 32, 2), ("ragged", 13, 37, 32, 1))
# the mixed instantiations' main path is the campaign at the recipe's batch
# 8: they are also checked and timed there (intra [145, 2504, 32], inter
# [313, 1160, 32])
SEQ_MIXED_R = {"intra": 2504, "inter": 1160}
# (name, x dtype, weight dtype): the three operand pairs of the trainers
SEQ_PAIRS = (("fp32", torch.float32, torch.float32),
             ("bf16", torch.bfloat16, torch.bfloat16),
             ("bf16_fp32w", torch.bfloat16, torch.float32))
# kernel vs plain: fp32 outputs max-abs, the Functions' weight gradients
# (sums over T*R rows in another order) max-abs over their peak; mixed:
# every output within 1e-2 of its peak (the slab's mixed bar), and the bf16
# outputs of the walks (y, gates, dgates; the Functions' y) equal to the
# plain versions' bit for bit at all but 5% of their elements. The two
# round at the same points: an fp32 sum in another order moves a value
# across a bf16 rounding boundary now and then, and the recurrence carries
# that on (up to 1% of the elements with the plain versions' products taken
# in float64, at these T and C, on the CPU). A rounding point moved or
# dropped (`rounding_controls`) changes 14-71% of them, with an error near
# 1e-2 of the peak.
SEQ_TOL = 1e-4
SEQ_MIXED_REL_TOL = 1e-2
SEQ_MIXED_SHARE = 0.05
SEQ_NAMES = ("lstm_seq_fwd", "lstm_seq_bwd", "blstm_seq_fwd",
             "blstm_seq_bwd")
# the cut campaign on the seq route: steps, val_every, then a resume for
# one more step
SEQ_STREAM_STEPS = (2, 2)


def seq_counts(lk):
    """(fp32 launches of rows 6-9, mixed launches of rows 6-9)."""
    fns = [getattr(lk, n) for n in SEQ_NAMES]
    return (tuple(f.launches for f in fns),
            tuple(f.mixed_launches for f in fns))


def reset_seq_counts(lk):
    for n in SEQ_NAMES:
        getattr(lk, n).launches = getattr(lk, n).mixed_launches = 0


def seq_grew(lk, before):
    now = seq_counts(lk)
    return tuple(tuple(a - b for a, b in zip(n, m))
                 for n, m in zip(now, before))


@contextlib.contextmanager
def plain_seq(lk):
    """Route the seq Functions to the plain versions of rows 6-9, on the
    card: the reference the kernels are held against."""
    saved = {n: getattr(lk, n) for n in SEQ_NAMES}
    for n in SEQ_NAMES:
        setattr(lk, n, getattr(lk, n + "_ref"))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(lk, n, f)


@contextlib.contextmanager
def patched(module, **names):
    """The module's attributes `names` replaced while inside."""
    saved = {n: getattr(module, n) for n in names}
    for n, f in names.items():
        setattr(module, n, f)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(module, n, f)


def rounding_controls(lk, ls):
    """(forward, backward) contexts under which the plain versions of rows
    6-9 round at one point otherwise: each sigmoid in float32 rounded once,
    as the mixed slab kernels round it (`lstm_slab.sigmoid_q`), in place of
    the Pallas bodies' three roundings; tanh of the cell state left in
    float32 in the backward walk. A kernel that rounded so must fail the
    mixed bar."""
    return (patched(lk, sigmoid_x=ls.sigmoid_q),
            patched(lk, tanh_q=lambda v: torch.tanh(v.float())))


def differ_share(got, want):
    """Share of the elements of each bf16 output that differ from want's."""
    return [float((g != w).float().mean()) for g, w in zip(got, want)
            if w.dtype == torch.bfloat16]


def seq_case(dev, t_len, r, c, nd, xdt, wdt, seed):
    """Operands of one recurrence (slab_case's draws) in the pair's dtypes:
    (fwd params, bwd params, x, h0, c0, dy [T, R, nd*H], dhT, dcT)."""
    a = slab_case(dev, t_len, r, c, seed)
    b = slab_case(dev, t_len, r, c, seed + 50)
    params = [{k: p[k].to(wdt) for k in ("w_ih", "w_hh", "b")}
              for p in (a, b)]
    dy = a["dy"] if nd == 1 else torch.cat([a["dy"], b["dy"]], dim=-1)
    return (*params, a["x"].to(xdt), a["h0"], a["c0"], dy.to(xdt), a["dhT"],
            a["dcT"])


def seq_rows(lk, nd, case, controls=None):
    """The forward and the backward of one route row pair on the case, each
    against its plain version on the same inputs: ((got, want) forward,
    (got, want) backward). `got` comes from the kernels or, given
    `controls` (a forward and a backward context), from the plain versions
    inside them."""
    fwd, bwd, x, h0, c0, dy, dhT, dcT = case
    if nd == 1:
        fargs = (fwd["w_ih"], fwd["w_hh"], fwd["b"], x, h0, c0)
        kf, pf = lk.lstm_seq_fwd, lk.lstm_seq_fwd_ref
        kb, pb = lk.lstm_seq_bwd, lk.lstm_seq_bwd_ref
    else:
        fargs = (*lk._blstm_pack(fwd, bwd), x)
        kf, pf = lk.blstm_seq_fwd, lk.blstm_seq_fwd_ref
        kb, pb = (lambda *a: (lk.blstm_seq_bwd(*a),),
                  lambda *a: (lk.blstm_seq_bwd_ref(*a),))
    want = pf(*fargs)
    bargs = ((want[1], want[2], c0, dy, dhT, dcT, fwd["w_hh"], x.dtype)
             if nd == 1 else (fargs[2], want[1], want[2], dy, x.dtype))
    want_b = pb(*bargs)
    if controls is None:
        got, got_b = kf(*fargs), kb(*bargs)
    else:
        with controls[0]:
            got = pf(*fargs)
        with controls[1]:
            got_b = pb(*bargs)
    torch.cuda.synchronize()
    return (got, want), (got_b, want_b)


def seq_function(lk, nd, case, plain):
    """One Function's forward and backward (kernels, or with `plain` their
    plain versions) on the case: (outputs, gradients), named."""
    fwd, bwd, x, h0, c0, dy, dhT, dcT = case
    leaf = {f"{d}.{k}": v.clone().requires_grad_()
            for d, p in (("fwd", fwd), ("bwd", bwd)) for k, v in p.items()}
    leaf.update(x=x.clone().requires_grad_(),
                h0=h0.clone().requires_grad_(),
                c0=c0.clone().requires_grad_())
    p = [{k: leaf[f"{d}.{k}"] for k in ("w_ih", "w_hh", "b")}
         for d in ("fwd", "bwd")]
    with plain_seq(lk) if plain else contextlib.nullcontext():
        if nd == 1:
            outs = lk.lstm_seq(p[0]["w_ih"], p[0]["w_hh"], p[0]["b"],
                               leaf["x"], leaf["h0"], leaf["c0"])
            loss = ((outs[0].float() * dy.float()).sum()
                    + (outs[1] * dhT).sum() + (outs[2] * dcT).sum())
            names = ("fwd.w_ih", "fwd.w_hh", "fwd.b", "x", "h0", "c0")
        else:
            outs = (lk.blstm_seq(p[0], p[1], leaf["x"]),)
            loss = (outs[0].float() * dy.float()).sum()
            names = ("fwd.w_ih", "fwd.w_hh", "fwd.b", "bwd.w_ih",
                     "bwd.w_hh", "bwd.b", "x")
        loss.backward()
    torch.cuda.synchronize()
    return ([o.detach() for o in outs],
            {n: leaf[n].grad for n in names})


def phase20_seq_kernels(dev, lk, ls):
    """Rows 6-9 against their plain versions on the card: fp32 and both
    mixed pairs at the flagship's batch-4 shapes and a ragged R, the mixed
    pairs again at the recipe's batch-8 shapes; the two Functions' outputs
    and gradients, kernels against plain versions; in each mixed case the
    rounding controls too, which must fail the mixed bar. Returns the worst
    max-abs error of each row, fp32 and mixed."""
    worst = {(n, m): 0.0 for n in SEQ_NAMES for m in (False, True)}
    cases = [(name, t_len, r, c, nd, SEQ_PAIRS)
             for name, t_len, r, c, nd in SEQ_SHAPES]
    cases += [(name + " batch 8", t_len, SEQ_MIXED_R[name], c, nd,
               SEQ_PAIRS[1:]) for name, t_len, _, c, nd in SEQ_SHAPES
              if name in SEQ_MIXED_R]
    for i, (name, t_len, r, c, nd, pairs) in enumerate(cases):
        rows = SEQ_NAMES[:2] if nd == 1 else SEQ_NAMES[2:]
        for pname, xdt, wdt in pairs:
            mixed = pname != "fp32"
            case = seq_case(dev, t_len, r, c, nd, xdt, wdt, SEED + 200 + i)
            before = seq_counts(lk)
            with torch.no_grad():
                got = seq_rows(lk, nd, case)
            errs = [rel_errs(g, w) for g, w in got]
            fn_got, fn_want = (seq_function(lk, nd, case, plain)
                               for plain in (False, True))
            grew = seq_grew(lk, before)
            fn_out = rel_errs(fn_got[0], fn_want[0])
            fn_grad = {k: rel_errs([fn_got[1][k]], [fn_want[1][k]])[0]
                       for k in fn_got[1]}
            shares = [s for g, w in (*got, (fn_got[0], fn_want[0]))
                      for s in differ_share(g, w)] if mixed else []
            # the walks' grids: the forwards (rows 6, 8) and the backwards
            # (rows 7, 9)
            code, n_sm = ls.DTYPES.index((xdt, wdt)), ls._n_sm(dev)
            sfx = "b" if mixed else "a"
            tiles = ("row %s %d rows a block, %d blocks; "
                     % (("6" if nd == 1 else "8") + sfx,
                        *ls.fwd_row_tiles(r, c, SLAB_H, n_sm, nd, code,
                                          bseq=mixed)))
            tiles += ("row %s %d rows a block, %d blocks; "
                      % (("7" if nd == 1 else "9") + sfx,
                         *lk.seq_bwd_row_tiles(r, SLAB_H, code, n_sm, nd)))
            log(f"  {name} [T={t_len}, R={r}, C={c}] x{nd} direction(s), "
                f"{pname}: {tiles}rows {'/'.join(rows)} max-abs (max-abs / "
                "peak) "
                "forward " + ", ".join(
                    f"{e[0]:.2e} ({e[1]:.2e})" for e in errs[0])
                + "; backward " + ", ".join(
                    f"{e[0]:.2e} ({e[1]:.2e})" for e in errs[1])
                + "; the Function's outputs " + ", ".join(
                    f"{e[0]:.2e}" for e in fn_out) + ", grads " + ", ".join(
                    f"{k} {e[0]:.2e} ({e[1]:.2e})"
                    for k, e in fn_grad.items())
                + f"; launches {grew}")
            want_grew = [0, 0, 0, 0]
            for n in rows:
                want_grew[SEQ_NAMES.index(n)] = 2   # the rows, the Function
            want_grew = ((0,) * 4, tuple(want_grew)) if mixed else \
                (tuple(want_grew), (0,) * 4)
            if grew != want_grew:
                fail(f"seq launches grew by {grew} at {name} {pname}, "
                     f"expected {want_grew}")
            dtypes = [(g.dtype, w.dtype) for gw in got for g, w in
                      zip(*gw)]
            if any(a != b for a, b in dtypes):
                fail(f"seq kernels at {name} {pname}: dtypes {dtypes}")
            if mixed:
                with torch.no_grad():
                    ctl = seq_rows(lk, nd, case, rounding_controls(lk, ls))
                ctl_share = [max(differ_share(g, w)) for g, w in ctl]
                ctl_err = max(e[1] for g, w in ctl for e in rel_errs(g, w))
                log(f"    bf16 elements that differ from the plain "
                    f"versions (y, gates, dgates, the Function's y): "
                    + ", ".join(f"{s:.2e}" for s in shares)
                    + f" (bar {SEQ_MIXED_SHARE}); the rounding controls: "
                    f"forward {ctl_share[0]:.2e}, backward "
                    f"{ctl_share[1]:.2e}, max-abs / peak {ctl_err:.2e}")
                if min(ctl_share) <= SEQ_MIXED_SHARE:
                    fail(f"the mixed bar does not catch the rounding "
                         f"controls at {name} {pname}: {ctl_share}")
                bad = max(e[1] for e in (*errs[0], *errs[1], *fn_out,
                                         *fn_grad.values()))
                ok = (bad <= SEQ_MIXED_REL_TOL
                      and max(shares) <= SEQ_MIXED_SHARE)
            else:
                weights = [e[1] for k, e in fn_grad.items()
                           if k.split(".")[-1] in ("w_ih", "w_hh", "b")]
                others = [e[0] for k, e in fn_grad.items()
                          if k.split(".")[-1] not in ("w_ih", "w_hh", "b")]
                ok = (max(e[0] for e in (*errs[0], *errs[1], *fn_out))
                      <= SEQ_TOL and max(weights) <= SEQ_TOL
                      and max(others) <= SEQ_TOL)
            if not ok:
                fail(f"seq kernels disagree with their plain versions at "
                     f"{name} {pname}")
            for n, e in zip(rows, errs):
                worst[n, mixed] = max(worst[n, mixed], *(x[0] for x in e))
    log("phase 20 seq kernels vs plain: worst max-abs " + ", ".join(
        f"{n}{' mixed' if m else ''} {e:.3e}" for (n, m), e in worst.items())
        + f" (fp32 tol {SEQ_TOL} max-abs, the Functions' weight grads "
        f"{SEQ_TOL} of their peak; mixed {SEQ_MIXED_REL_TOL} of the peak "
        f"and at most {SEQ_MIXED_SHARE} of the bf16 elements differing)")
    return worst


def route_step(args, init_ckpt, batch, dev, lstm_scan):
    """One PLModule train step from init_ckpt on batch, on `lstm_scan`:
    (module, loss, pre-clip grad norm, clipped grads, updated weights)."""
    from sound_bubble_tpu_torch.train.module import PLModule

    mod = PLModule(**{**args, "init_ckpt": init_ckpt}, device=dev,
                   lstm_scan=lstm_scan)
    loss, _ = mod.training_step(batch)
    torch.cuda.synchronize()
    grads = {k: p.grad.cpu().numpy() for k, p in mod.net.named_parameters()}
    weights = {k: v.cpu().numpy() for k, v in mod.net.state_dict().items()}
    return mod, loss, float(mod.last_grad_norm), grads, weights


def seq_vs_slab_step(args, init_ckpt, batch, dev, lk, golden_path):
    """One step on the seq route and one on the slab route, from the same
    weights on the same batch: the seq step launches rows 6-9 once a block
    each and agrees with the slab step (the same function in fp32) and
    with the JAX golden. Returns (seq module, loss, grad norm)."""
    n_blocks = args["model_params"]["B"]
    before = seq_counts(lk)
    mod, loss_q, norm_q, grads_q, w_q = route_step(args, init_ckpt, batch,
                                                   dev, "seq")
    grew = seq_grew(lk, before)
    _, loss_s, norm_s, _, w_s = route_step(args, init_ckpt, batch, dev,
                                           "slab")
    rel_loss = abs(loss_q - loss_s) / abs(loss_s)
    rel_norm = abs(norm_q - norm_s) / norm_s
    w_err = max(check_adam_step(k, w_q[k], w_s[k], grads_q[k],
                                mod.get_current_lr()) for k in w_q)
    log(f"  one step from {os.path.relpath(init_ckpt, REPO)}, seq route vs "
        f"slab route on the card: loss {loss_q:.6f} vs {loss_s:.6f} (rel "
        f"{rel_loss:.2e}, tol {STEP_LOSS_REL_TOL}); pre-clip grad norm "
        f"{norm_q:.6f} vs {norm_s:.6f} (rel {rel_norm:.2e}, tol "
        f"{STEP_NORM_REL_TOL}); updated weights max-abs {w_err:.2e} where "
        f"|g| > 1e-3 of the leaf's peak; seq launches in the step {grew}")
    if grew != ((n_blocks,) * 4, (0,) * 4):
        fail(f"seq step launches {grew}, expected {n_blocks} of each fp32 "
             "row")
    if not (rel_loss <= STEP_LOSS_REL_TOL and rel_norm <= STEP_NORM_REL_TOL):
        fail("the seq route and the slab route disagree on one train step")
    check_step_golden(loss_q, norm_q, grads_q, args["grad_clip"],
                      golden_path)
    return mod


def phase21_seq_train(dev, lk, ls):
    """fp32 training on the seq route: `train_pt --lstm_scan seq`, 1 epoch
    (the main path of the fp32 instantiations of rows 6-9), a resume on the
    slab route refused; one flagship step from best.pt on the golden batch
    against the slab route's and the JAX golden. Returns (the main path's
    fp32 launches of rows 6-9, the seq module, the batch)."""
    from sound_bubble_tpu_torch import train_pt
    from sound_bubble_tpu_torch.data.synth import (
        golden_batch, write_sample_dirs)

    with open(TRAIN_CONFIG) as fh:
        cfg = json.load(fh)
    args = cfg["pl_module_args"]
    n_blocks = args["model_params"]["B"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_seq_")
    try:
        n_train, n_val = 4, 2
        dirs = write_sample_dirs(os.path.join(tmp, "data"), SEED + 21,
                                 n_train, n_val)
        point_at_scenes(cfg, dirs)
        cfg["num_workers"] = 2
        steps = math.ceil(3 * n_train / cfg["batch_size"])
        val_batches = math.ceil(3 * n_val / cfg["eval_batch_size"])
        cfg_path, run_dir = (os.path.join(tmp, "config.json"),
                             os.path.join(tmp, "run"))
        # ---- the main path: train_pt on the seq route
        reset_seq_counts(lk)
        _, secs, slab_f, slab_b = run_train_pt(
            cfg, cfg_path, run_dir, 1, ls, ["--lstm_scan", "seq"])
        counts = seq_counts(lk)
        per = ((steps + val_batches) * n_blocks, steps * n_blocks)
        want = ((per[0], per[1], per[0], per[1]), (0,) * 4)
        with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
            logged = [json.loads(line) for line in fh]
        with open(os.path.join(run_dir, train_pt.ARGS_FILE)) as fh:
            recorded = json.load(fh)
        log(f"phase 21 seq training: train_pt --lstm_scan seq, 1 epoch x "
            f"{steps} steps + {val_batches} val batch(es) in {secs:.2f} s; "
            f"seq launches (fp32 rows 6-9, mixed) {counts} (expected "
            f"{want}); slab launches {slab_f}, {slab_b}; recorded "
            f"{recorded}; log {logged}")
        if counts != want or (slab_f, slab_b) != (0, 0):
            fail(f"train_pt on the seq route: launches {counts}, slab "
                 f"{(slab_f, slab_b)}")
        losses = [e[k] for e in logged for k in ("train/loss", "val/loss")]
        if (len(logged) != 1 or not np.isfinite(losses).all()
                or recorded != {"lstm_scan": "seq"}):
            fail(f"train_pt on the seq route: log {logged}, args {recorded}")
        # ---- a resume on the other route is refused
        try:
            train_pt.train(train_pt.parse_args(
                ["--config", cfg_path, "--run_dir", run_dir, "--seed",
                 str(SEED), "--lstm_scan", "slab"]))
            refused = ""
        except SystemExit as e:
            refused = str(e)
        log(f"  resume with --lstm_scan slab: {refused!r}")
        if "refused" not in refused:
            fail("train_pt resumed a seq run on the slab route")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    batch = golden_batch(SEED)
    mod = seq_vs_slab_step(args, os.path.join(RUN_DIR, "checkpoints",
                                              "best.pt"), batch, dev, lk,
                           TRAIN_STEP_GOLDEN)
    return counts[0], mod, batch


def stream_argv(recipe, cfg_path, run_dir):
    """train_stream's arguments for the flagship recipe, cut (STREAM_CUTS)."""
    return ["--config", cfg_path, "--run_dir", run_dir,
            "--bf16" if recipe["bf16"] else "--no-bf16",
            "--voice", recipe["voice"], "--batch", str(recipe["batch"]),
            "--clip_seconds", str(recipe["clip_seconds"]),
            "--snr_min", str(recipe["snr_range"][0]),
            "--snr_max", str(recipe["snr_range"][1]),
            "--bg_noise", str(recipe["bg_noise"]), "--seed", str(SEED),
            *STREAM_CUTS]


def phase22_seq_bf16(dev, lk, ls):
    """The bf16 recipe on the seq route: one step (cast_bf16, the bf16
    trunk) from best.pt on the golden batch against the JAX bf16 golden;
    then `train_stream --lstm_scan seq` cut (the main path of the mixed
    instantiations), a --resume, and a resume on the slab route refused.
    Returns the main path's mixed launches of rows 6-9."""
    from sound_bubble_tpu_torch import train_stream
    from sound_bubble_tpu_torch.data.synth import golden_batch
    from sound_bubble_tpu_torch.train.checkpoint import load_checkpoint
    from sound_bubble_tpu_torch.train.module import PLModule

    # the step as the golden took it: the pretrain config's module
    with open(TRAIN_CONFIG) as fh:
        args = json.load(fh)["pl_module_args"]
    flagship = os.path.join(RUN_DIR, "checkpoints", "best.pt")
    n_blocks = args["model_params"]["B"]
    batch = golden_batch(SEED)
    steps = {}
    for scan in ("seq", "slab"):
        mod = PLModule(**{**args, "init_ckpt": flagship}, device=dev,
                       lstm_scan=scan)
        mod.set_bf16_trunk()
        model_in = mod._model_inputs(batch[0])
        gt = torch.from_numpy(batch[1]["target"]).to(dev)
        before = seq_counts(lk)
        loss, _ = train_stream.train_step(mod, model_in, gt, True)
        torch.cuda.synchronize()
        steps[scan] = (float(loss), float(mod.last_grad_norm),
                       seq_grew(lk, before))
    goldens = {}
    for path in (BF16_SEQ_STEP_GOLDEN, BF16_STEP_GOLDEN):
        with open(path) as fh:
            goldens[path] = json.load(fh)
    golden = goldens[BF16_SEQ_STEP_GOLDEN]
    loss_q, norm_q, grew = steps["seq"]

    def rel_to(g, loss, norm):
        return (abs(loss - g["loss"]) / abs(g["loss"]),
                abs(norm - g["grad_norm"]) / g["grad_norm"])

    rel = rel_to(golden, loss_q, norm_q)
    slab_g = goldens[BF16_STEP_GOLDEN]
    log(f"phase 22 bf16 step on the seq route (train_stream.train_step, "
        f"cast_bf16) from {os.path.relpath(flagship, REPO)} on the golden "
        f"batch: loss {loss_q:.6f}, pre-clip grad norm {norm_q:.6f}; JAX "
        f"golden on the same route "
        f"({os.path.basename(BF16_SEQ_STEP_GOLDEN)}) {golden['loss']:.6f}, "
        f"{golden['grad_norm']:.6f} (rel {rel[0]:.2e}, {rel[1]:.2e}; tol "
        f"{BF16_LOSS_REL_TOL}, {BF16_NORM_REL_TOL}). For information, the "
        f"slab route: the port's {steps['slab'][0]:.6f}, "
        f"{steps['slab'][1]:.6f}; JAX's "
        f"({os.path.basename(BF16_STEP_GOLDEN)}) {slab_g['loss']:.6f}, "
        f"{slab_g['grad_norm']:.6f}; the port's seq step against it rel "
        "%.2e, %.2e; JAX's two routes apart rel %.2e, %.2e; seq launches "
        % (*rel_to(slab_g, loss_q, norm_q),
           *rel_to(slab_g, golden["loss"], golden["grad_norm"]))
        + str(grew))
    if grew != ((0,) * 4, (n_blocks,) * 4):
        fail(f"bf16 seq step launches {grew}, expected {n_blocks} of each "
             "mixed row")
    if not (rel[0] <= BF16_LOSS_REL_TOL and rel[1] <= BF16_NORM_REL_TOL):
        fail(f"the bf16 seq step disagrees with the JAX golden: {rel}")

    with open(os.path.join(RUN_DIR, "train_stream_args.json")) as fh:
        recipe = json.load(fh)
    with open(os.path.join(RUN_DIR, "config.json")) as fh:
        cfg = json.load(fh)
    cfg["pl_module_args"]["init_ckpt"] = flagship
    tmp = tempfile.mkdtemp(prefix="chip_smoke_seq_stream_")
    try:
        cfg_path, run_dir = (os.path.join(tmp, "config.json"),
                             os.path.join(tmp, "run"))
        with open(cfg_path, "w") as fh:
            json.dump(cfg, fh)
        argv = stream_argv(recipe, cfg_path, run_dir) + ["--lstm_scan",
                                                         "seq"]
        n, every = SEQ_STREAM_STEPS
        # ---- the main path: the campaign's first steps and validation
        reset_seq_counts(lk)
        ls.lstm_slab_fwd.mixed_launches = ls.lstm_slab_bwd.mixed_launches = 0
        t = time.perf_counter()
        mod = train_stream.main(train_stream.parse_args(
            argv + ["--steps", str(n), "--val_every", str(every)]))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        counts = seq_counts(lk)
        per = ((n + 1) * n_blocks, n * n_blocks)
        want = ((0,) * 4, (per[0], per[1], per[0], per[1]))
        slab = (ls.lstm_slab_fwd.mixed_launches,
                ls.lstm_slab_bwd.mixed_launches)
        with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
            logged = [json.loads(line) for line in fh]
        log(f"  train_stream --lstm_scan seq, the recipe cut to "
            f"{' '.join(STREAM_CUTS)} --steps {n} --val_every {every}: "
            f"{run_s:.2f} s incl. the pool build; seq launches {counts} "
            f"(expected {want}); mixed slab launches {slab}; log {logged}")
        if counts != want or slab != (0, 0):
            fail(f"train_stream on the seq route: launches {counts}, slab "
                 f"{slab}")
        vals = [r["val_loss"] for r in logged if "val_loss" in r]
        if (len(vals) != 1 or not np.isfinite(vals).all()
                or mod.net.cfg.compute_dtype != "bf16"
                or mod.net.lstm_scan != "seq"):
            fail(f"train_stream on the seq route: validations {vals}")
        # ---- resume for one more step on the same route
        before = seq_counts(lk)
        mod = train_stream.main(train_stream.parse_args(
            argv + ["--steps", str(n + 1), "--val_every", str(every),
                    "--resume"]))
        torch.cuda.synchronize()
        grew = seq_grew(lk, before)
        last = load_checkpoint(os.path.join(run_dir, "checkpoints",
                                            "last.pt"))
        # ---- and on the other route: refused
        slab_argv = argv[:-1] + ["slab"]
        try:
            train_stream.main(train_stream.parse_args(
                slab_argv + ["--steps", str(n + 2), "--resume"]))
            refused = ""
        except SystemExit as e:
            refused = str(e)
        log(f"  resumed at step {n} for one step: seq launches {grew}, "
            f"last.pt at epoch {last['current_epoch']}; a resume with "
            f"--lstm_scan slab: {refused!r}")
        if (grew != ((0,) * 4, (2 * n_blocks, n_blocks) * 2)
                or "refused" not in refused):
            fail("the seq campaign's resume took another route or length")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts[1]


def phase23_seq_edge(dev, lk):
    """One Orange Pi finetune step (conv_lstm intra BLSTM over k = 29
    frames) on the seq route from the seeded weights, against the slab
    route's and the JAX golden."""
    from sound_bubble_tpu_torch.data.synth import golden_batch

    with open(EDGE_CONFIG.format("orangpi", "finetune")) as fh:
        args = json.load(fh)["pl_module_args"]
    log("phase 23 edge finetune step on the seq route:")
    seq_vs_slab_step(args, os.path.join(EDGE_RUN_DIR, "checkpoints",
                                        "best.pt"), golden_batch(SEED), dev,
                     lk, EDGE_STEP_GOLDEN)


def seq_bound_ms(t_len, r, c, h, nd, kind, xb=4, wb=4):
    """Least time for one launch of rows 6-9 on an H100: the larger of the
    bytes the function must move (each input read once, each output written
    once) over 3.35 TB/s and its matrix-product FLOPs over the fp32 rate
    (the mixed mode, xb = 2 for x, y, dy, dgates and the saved gates, wb for
    the weights: at the bf16 tensor-core rate). Forward: x, the weights
    (each direction's own, not the pack's zero blocks), h0 and c0 in; y,
    gates and c out; the input projection and the recurrence. Backward:
    gates, c, dy, W_hh (and c0, dhT, dcT) in; dgates (and dh0, dc0) out;
    the dh chain. The entering c is c shifted by one step, not an input of
    its own. Gate nonlinearities and the elementwise gradient are not
    counted."""
    n, g = t_len * r, 4 * h
    state = 4 * r * h if nd == 1 else 0        # one [R, H] fp32 tensor
    if kind == "fwd":
        flops = 2 * n * nd * (c + h) * g
        n_bytes = (xb * n * c + wb * nd * ((c + h) * g + g) + 2 * state
                   + xb * n * nd * h + xb * n * nd * g + 4 * n * nd * h)
    else:
        flops = 2 * n * nd * g * h
        n_bytes = (xb * n * nd * g + 4 * n * nd * h + xb * n * nd * h
                   + wb * nd * h * g + 3 * state
                   + xb * n * nd * g + 2 * state)
    peak = PEAK_FP32_FLOPS if xb == 4 and wb == 4 else PEAK_BF16_FLOPS
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")), flops, n_bytes


def seq_backward_ms(lk, nd, case, n):
    """ms of the row pair's whole Function backward: the walk and the
    products outside it (dW_ih, dW_hh, db, dx; dh0 and dc0 come from the
    walk). cuDNN's LSTM backward computes the same gradients, so this, and
    not the walk alone, is the port's side of that comparison."""
    fwd, bwd, x, h0, c0, dy, dhT, dcT = case
    p = [{k: v.clone().requires_grad_() for k, v in q.items()}
         for q in (fwd, bwd)]
    xg = x.clone().requires_grad_()
    if nd == 1:
        outs = lk.lstm_seq(p[0]["w_ih"], p[0]["w_hh"], p[0]["b"], xg, h0,
                           c0)
        grads, leaves = (dy, dhT, dcT), [*p[0].values(), xg]
    else:
        outs, grads = (lk.blstm_seq(p[0], p[1], xg),), (dy,)
        leaves = [*p[0].values(), *p[1].values(), xg]
    return cuda_ms(lambda: torch.autograd.grad(outs, leaves, grads,
                                               retain_graph=True), n)


def phase24_seq_times(dev, lk, card, mod_seq, batch):
    """Per-launch times of rows 6-9 (fp32 at the fp32 step's shapes, mixed
    at the recipe's), their plain versions, bounds and cuDNN's LSTM
    (unidirectional for rows 6-7, bidirectional for 8-9; its backward also
    computes the weight and input gradients, so the Functions' whole
    backward is timed beside it); ms per step and peak memory, seq route
    against slab route, fp32 (batch 4) and the bf16 recipe (batch 8).
    Returns the kernels-line numbers of each row, fp32 and mixed."""
    from sound_bubble_tpu_torch import train_stream
    from sound_bubble_tpu_torch.data.synth import golden_batch
    from sound_bubble_tpu_torch.train.module import PLModule

    shapes = {name: rest for name, *rest in SEQ_SHAPES}
    rows = {}
    for mixed in (False, True):
        xdt = torch.bfloat16 if mixed else torch.float32
        nb = 2 if mixed else 4
        for name in ("inter", "intra"):
            t_len, r, c, nd = shapes[name]
            if mixed:
                r = SEQ_MIXED_R[name]
            case = seq_case(dev, t_len, r, c, nd, xdt, xdt, SEED)
            fwd, bwd, x, h0, c0, dy, dhT, dcT = case
            pack = lk._blstm_pack(fwd, bwd)
            if nd == 1:
                fargs = (fwd["w_ih"], fwd["w_hh"], fwd["b"], x, h0, c0)
                kf, pf = lk.lstm_seq_fwd, lk.lstm_seq_fwd_ref
                kb, pb = lk.lstm_seq_bwd, lk.lstm_seq_bwd_ref
            else:
                fargs = (*pack, x)
                kf, pf = lk.blstm_seq_fwd, lk.blstm_seq_fwd_ref
                kb, pb = lk.blstm_seq_bwd, lk.blstm_seq_bwd_ref
            with torch.no_grad():
                out = kf(*fargs)
                bargs = ((out[1], out[2], c0, dy, dhT, dcT, fwd["w_hh"],
                          xdt) if nd == 1 else
                         (pack[2], out[1], out[2], dy, xdt))
                fwd_ms = cuda_ms(lambda: kf(*fargs), 20)
                bwd_ms = cuda_ms(lambda: kb(*bargs), 20)
                fwd_plain = cuda_ms(lambda: pf(*fargs), 1)
                bwd_plain = cuda_ms(lambda: pb(*bargs), 1)
            lib_fwd, lib_bwd = cudnn_lstm_ms(
                dev, dict(x=x, h0=h0, c0=c0, dy=dy), 10, xdt,
                bidirectional=nd == 2)
            whole_bwd = seq_backward_ms(lk, nd, case, 10)
            b_f, ff, fbytes = seq_bound_ms(t_len, r, c, SLAB_H, nd, "fwd",
                                           xb=nb, wb=nb)
            b_b, bf, bbytes = seq_bound_ms(t_len, r, c, SLAB_H, nd, "bwd",
                                           xb=nb, wb=nb)
            tag = "mixed " if mixed else ""
            if nd == 2 and not mixed:
                tag = ("(row 8a %d rows a block, %d blocks) "
                       % lk.fwd_row_tiles(r, c, SLAB_H, lk._n_sm(dev), nd))
            names = SEQ_NAMES[:2] if nd == 1 else SEQ_NAMES[2:]
            for kname, ms, plain, (bound, by), lib in (
                    (names[0], fwd_ms, fwd_plain, b_f, lib_fwd),
                    (names[1], bwd_ms, bwd_plain, b_b, lib_bwd)):
                rows[kname, mixed] = dict(ms=ms, plain_ms=plain,
                                          bound_ms=bound, bound_by=by,
                                          library_ms=lib)
            log(f"  {tag}{names[0]} / {names[1]} [T={t_len}, R={r}, C={c}] "
                f"x{nd} on {card}: fwd {fwd_ms:.4f} ms (plain "
                f"{fwd_plain:.2f}, cuDNN {'bi' if nd == 2 else 'uni'}"
                f"directional {xdt} LSTM fwd {lib_fwd:.4f}, bound "
                f"{b_f[0]:.6f} {b_f[1]}: {ff} FLOP, {fbytes} B); bwd "
                f"{bwd_ms:.4f} ms (plain {bwd_plain:.2f}, cuDNN bwd "
                f"{lib_bwd:.4f}, bound {b_b[0]:.6f} {b_b[1]}: {bf} FLOP, "
                f"{bbytes} B); the Function's whole backward (the walk, "
                f"dW_ih, dW_hh, db, dx: what cuDNN's bwd computes) "
                f"{whole_bwd:.4f} ms")

    # ms per step and peak memory: the fp32 step (batch 4) and the bf16
    # recipe (batch 8), each on the seq and the slab route, in turns
    with open(TRAIN_CONFIG) as fh:
        args = json.load(fh)["pl_module_args"]
    flagship = os.path.join(RUN_DIR, "checkpoints", "best.pt")
    mods = {"seq": mod_seq,
            "slab": PLModule(**{**args, "init_ckpt": flagship}, device=dev)}
    fp32 = {}
    for scan in ("seq", "slab", "slab", "seq"):
        fp32.setdefault(scan, []).append(train_step_ms(mods[scan], batch,
                                                       dev))
    del mods
    b0, b1 = golden_batch(SEED), golden_batch(SEED + 1)
    inputs = {k: np.concatenate([b0[0][k], b1[0][k]]) for k in b0[0]
              if k in ("mixture", "dis_embed")}
    gt8 = np.concatenate([b0[1]["target"], b1[1]["target"]])
    bf16 = {}
    for scan in ("seq", "slab"):
        mod = bf16_module({**args, "lstm_scan": scan}, flagship, dev)
        model_in = mod._model_inputs(inputs)
        gt = torch.from_numpy(gt8).to(dev)
        train_stream.train_step(mod, model_in, gt, True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        for _ in range(5):
            train_stream.train_step(mod, model_in, gt, True)
        torch.cuda.synchronize()
        bf16[scan] = ((time.perf_counter() - t) / 5 * 1e3,
                      torch.cuda.max_memory_allocated() / 1e9)
        del mod
    in_step = {m: sum(6 * (rows[k, m]["ms"]) for k in SEQ_NAMES)
               for m in (False, True)}
    log(f"phase 24 seq times on {card}: fp32 train step (PLModule."
        f"train_step, batch 4 x 2.5 s, host clock, 5 steps, seq, slab, "
        f"slab, seq) seq " + ", ".join(f"{ms:.2f} ms / {gb:.2f} GB" for
                                       ms, gb in fp32["seq"])
        + "; slab " + ", ".join(f"{ms:.2f} ms / {gb:.2f} GB" for ms, gb in
                                fp32["slab"])
        + f"; rows 6-9 x 6 launches each {in_step[False]:.2f} ms. bf16 "
        f"recipe step (train_stream.train_step, batch 8 x 2.5 s): seq "
        f"{bf16['seq'][0]:.2f} ms / {bf16['seq'][1]:.2f} GB, slab "
        f"{bf16['slab'][0]:.2f} ms / {bf16['slab'][1]:.2f} GB; mixed rows "
        f"6-9 x 6 launches each {in_step[True]:.2f} ms")
    return rows


# ---- phases 25-28: the rest of serving: row 5, the fused inference BLSTM
# (`ops/kernels/lstm_kernel.py`, `csrc/lstm_infer.cu`), on the model-level
# streaming path and the offline eval CLIs

# (name, R, T, C) at H = 64: one stream at the flagship's width (F = 145,
# C = 32; the serving main path's shape), four streams, one stream at the
# conv_lstm width (Orange Pi: k = 145 // 5 = 29 frames, C = 24), and the
# offline forward of a 2 s golden (250 frames)
ROW5_SHAPES = (("serve1", 1, 145, 32), ("serve4", 4, 145, 32),
               ("conv1", 1, 29, 24), ("offline", 250, 145, 32))
ROW5_H = 64
# fp32 kernel vs fp32 plain version: another summation order over H terms
# a direction (the plain version multiplies by the whole pack)
ROW5_TOL = 1e-5
# STOI and PESQ of the eval CLI on the card vs the JAX package's on the CPU.
# runs/goldens_eval_syn_jax.json records their CPU sensitivity
# (`sensitivity`): the port's CPU output moves them by at most 4.5e-6 from
# JAX's, white noise at the whole-model bar (max-abs ~1e-4 of the output's
# peak) by at most 1.5e-4; the bar is ~7x the latter
EVAL_PERCEPTUAL_TOL = 1e-3
EVAL_GOLDENS = os.path.join(REPO, "runs", "goldens_eval_syn_jax.json")
EVAL_TIMEOUT_S = 600


def row5_bound_ms(t_len, r, c, h):
    """Least time for row 5's whole function (one launch): x [R, T, C] and
    each direction's W_ih, W_hh and b in, y [R, T, 2H] out, 4 bytes each,
    over 3.35 TB/s; the projection's and the recurrence's
    2*T*R*2*(C+H)*4H FLOP over the fp32 rate."""
    n_bytes = 4 * (t_len * r * c + 2 * (c + h + 1) * 4 * h
                   + t_len * r * 2 * h)
    flops = 2 * t_len * r * 2 * (c + h) * 4 * h
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row5_cases(dev, nets):
    """{name: (params, x)}: block 0's intra BLSTM of the flagship (C = 32)
    or the Orange Pi net (C = 24), x [R, T, C] from SEED."""
    rng = np.random.default_rng(SEED)
    cases = {}
    for name, r, t_len, c in ROW5_SHAPES:
        net = nets["flagship" if c == 32 else "edge"]
        params = net.block0.intra.blstm
        x = torch.from_numpy(rng.standard_normal((r, t_len, c))
                             .astype(np.float32)).to(dev)
        cases[name] = (params, x)
    return cases


def phase25_row5_kernel(rk, cases):
    """Row 5 against its plain version on the card at ROW5_SHAPES."""
    errs = {}
    before = rk.blstm_infer.launches
    with torch.no_grad():
        for name, (params, x) in cases.items():
            got = rk.blstm_infer(params, x)
            want = rk.blstm_infer_ref(params, x)
            torch.cuda.synchronize()
            if got.shape != x.shape[:2] + (2 * ROW5_H,):
                fail(f"row 5 {name}: output shape {tuple(got.shape)}")
            errs[name] = float((got - want).abs().max())
    grew = rk.blstm_infer.launches - before
    log(f"phase 25 row 5 (blstm_infer) vs plain: max-abs err "
        f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (tol {ROW5_TOL}), "
        f"launches +{grew}")
    if not max(errs.values()) <= ROW5_TOL:
        fail(f"row 5 disagrees with its plain version: {errs}")
    if grew != len(cases):
        fail(f"row 5 launches grew by {grew}, expected {len(cases)}")
    return max(errs.values())


def phase26_row5_serving(dev, rk, streamer):
    """The main path of row 5: the 9 goldens streamed through the
    model-level `ModelWrapper` (a PLModule's `model` handle,
    `load_torch_pretrained(..., pallas_blstm=True)`), every intra BLSTM on
    row 5, against the JAX package's numbers; one clip against the same
    weights on the slab kernels and through `FusedStreamer`;
    `streaming_inference_scan` (the CUDA graph) against the loop. Returns
    (row-5 launches of the main path, chunks, the row-5 net)."""
    from sound_bubble_tpu_torch import utils
    from sound_bubble_tpu_torch.evaluation import (
        load_testcase, one_hot, run_testcase)
    from sound_bubble_tpu_torch.metrics.metrics import (
        Metrics, compute_decay)
    from sound_bubble_tpu_torch.ops import kernels
    from sound_bubble_tpu_torch.ops.kernels import lstm_slab as ls
    from sound_bubble_tpu_torch.ops.stft import mod_pad
    from sound_bubble_tpu_torch.runtime.streaming import (
        ModelWrapper, streaming_inference, streaming_inference_scan)

    handle = utils.load_torch_pretrained(RUN_DIR, device=dev,
                                         pallas_blstm=True).model
    wrapper = ModelWrapper(handle, device=dev)
    cfg = wrapper.cfg
    chunk, pad = cfg.stft_chunk_size, cfg.stft_pad_size
    with open(JAX_BASELINE) as fh:
        jax_base = json.load(fh)
    si_sdr_i = Metrics("si_sdr_i")

    def stream(wrap, mixture, threshold):
        xp, mod = mod_pad(torch.from_numpy(mixture)[None], chunk,
                          (cfg.stft_back_pad, pad))
        wrap.reset()
        y = streaming_inference(wrap, xp, chunk, pad,
                                dis_embed=one_hot(threshold))[0]
        return (y[..., :-mod] if mod else y).cpu().numpy(), xp

    failures, n_chunks, clip = [], 0, None
    rk.blstm_infer.launches = 0
    ls.lstm_slab_fwd.launches = 0
    t = time.perf_counter()
    for radius, threshold in RADII:
        rdir = os.path.join(GOLDENS, f"syn_{radius}")
        for name in sorted(os.listdir(rdir)):
            _, mixture, gt, tgt, _ = load_testcase(
                os.path.join(rdir, name), 24000, threshold)
            out, xp = stream(wrapper, mixture, threshold)
            n_chunks += (xp.shape[-1] - pad) // chunk
            if out.shape != (cfg.num_src, mixture.shape[-1]) \
                    or not np.isfinite(out).all():
                fail(f"row-5 serving {radius}/{name}: output shape "
                     f"{out.shape} or non-finite values")
            if tgt:
                key, v = "sisdri", float(si_sdr_i(est=out, gt=gt,
                                                   mix=mixture[0:1]))
            else:
                key, v = "decay", float(compute_decay(est=out,
                                                      mix=mixture[0:1]))
            want = jax_base["samples"][f"{radius}/{name}"][key]
            if not abs(v - want) <= PARITY_TOL_DB:
                failures.append(f"{radius}/{name} {key} {v:.5f} vs JAX "
                                f"{want:.5f}")
            if (radius, name) == ("1m", "00002"):
                clip = (mixture, out, xp)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    launches, slab_n = rk.blstm_infer.launches, ls.lstm_slab_fwd.launches
    log(f"phase 26 row-5 serving (ModelWrapper + streaming_inference, "
        f"pallas_blstm=True): 9 goldens, {n_chunks} chunks in "
        f"{serve_s:.2f} s ({serve_s / n_chunks * 1e3:.3f} ms/chunk incl. "
        f"metrics); row-5 launches {launches} ({cfg.B} a chunk expected), "
        f"slab forward launches {slab_n}")
    if failures:
        fail("row-5 serving vs JAX (tol 0.01 dB): " + "; ".join(failures))
    if launches != cfg.B * n_chunks or slab_n != 0:
        fail(f"row 5 launched {launches} times (slab {slab_n}) for "
             f"{n_chunks} chunks of {cfg.B} blocks")

    mixture, row5, xp = clip
    peak = np.abs(row5).max()
    slab, _ = stream(ModelWrapper(streamer.net, device=dev), mixture, 1.0)
    fused = run_testcase(streamer, mixture, 1.0)
    before = kernels.launch_counts()
    scan = streaming_inference_scan(handle._module.net, xp, chunk, pad,
                                    dis_embed=one_hot(1.0), device=dev)[0]
    torch.cuda.synchronize()
    scan_grew = (kernels.launch_counts()["blstm_infer.launches"]
                 - before["blstm_infer.launches"])
    scan = scan.cpu().numpy()[..., :mixture.shape[-1]]
    rels = {"slab": float(np.abs(slab - row5).max() / peak),
            "fused": float(np.abs(fused - row5).max() / peak),
            "scan": float(np.abs(scan - row5).max() / peak)}
    n_clip = (xp.shape[-1] - pad) // chunk
    log(f"  syn_1m/00002, {n_clip} chunks: row 5 vs the slab kernels "
        f"{rels['slab']:.3e}, vs FusedStreamer {rels['fused']:.3e}, "
        f"streaming_inference_scan (CUDA graph) vs the loop "
        f"{rels['scan']:.3e} (max-abs / peak, tol {STREAM_REL_TOL}); the "
        f"graph's row-5 count +{scan_grew} (warm-up + {n_clip} replays x "
        f"{cfg.B})")
    if not max(rels.values()) <= STREAM_REL_TOL:
        fail(f"row-5 serving disagrees: {rels}")
    if scan_grew != cfg.B * (n_clip + 1):
        fail(f"the graph's row-5 count grew by {scan_grew}, expected "
             f"{cfg.B * (n_clip + 1)}")
    return launches, n_chunks, handle._module.net


def read_results(path):
    """results.csv -> {sample: {column: str}}."""
    with open(path, newline="") as fh:
        return {rec["sample"]: rec for rec in csv.DictReader(fh)}


def phase27_eval_clis():
    """`python -m sound_bubble_tpu_torch.eval_syn` on the three golden dirs
    (flagship, each at its radius) and `eval --distance_threshold -1` on
    the Orange Pi seeded run, as subprocesses at once, SB_PALLAS_BLSTM=1:
    row 5 launched in each (the CLI's last line), per-sample SI-SDRi and
    decay within 0.01 dB of the JAX package's, STOI and PESQ within
    EVAL_PERCEPTUAL_TOL; the CLIs load phase 2's library (its file is the
    same after them: no process built one). Returns {job: wall seconds}."""
    from sound_bubble_tpu_torch.ops.kernels import _build

    lib = _build.load_library()._name
    built = os.stat(lib).st_ino
    with open(JAX_BASELINE) as fh:
        jax_base = json.load(fh)
    with open(EVAL_GOLDENS) as fh:
        golden = json.load(fh)
    env = dict(os.environ, SB_PALLAS_BLSTM="1")
    tmp = tempfile.mkdtemp(prefix="sbt_eval_")
    jobs = {}
    for radius, threshold in RADII:
        jobs[f"eval_syn {radius}"] = (
            "eval_syn", os.path.join(GOLDENS, f"syn_{radius}"), RUN_DIR,
            ["--distance_threshold", str(threshold)], 6 * 3)
    jobs["eval -1 1_5m"] = (
        "eval", os.path.join(GOLDENS, "syn_1_5m"), EDGE_RUN_DIR,
        ["--distance_threshold", "-1", "--gt_threshold", "1.5"], 3 * 3)
    procs, walls, texts = {}, {}, {}
    try:
        t0 = time.perf_counter()
        for job, (cli, test_dir, run_dir, flags, _) in jobs.items():
            out = os.path.join(tmp, job.replace(" ", "_"))
            with open(out + ".log", "w") as log_f:
                procs[job] = (out, subprocess.Popen(
                    [sys.executable, "-m", f"sound_bubble_tpu_torch.{cli}",
                     test_dir, run_dir, out, *flags], cwd=REPO, env=env,
                    stdout=log_f, stderr=subprocess.STDOUT))
        while len(walls) < len(procs):
            if time.perf_counter() - t0 > EVAL_TIMEOUT_S:
                fail(f"eval CLIs still running after {EVAL_TIMEOUT_S} s")
            for job, (out, proc) in procs.items():
                if job not in walls and proc.poll() is not None:
                    walls[job] = time.perf_counter() - t0
            time.sleep(0.2)
        for job, (out, proc) in procs.items():
            with open(out + ".log") as log_f:
                texts[job] = log_f.read()
            if proc.returncode != 0:
                fail(f"{job} exited {proc.returncode}:\n{texts[job][-3000:]}")
        failures = []
        for job, (cli, test_dir, run_dir, flags, n_launch) in jobs.items():
            last = texts[job].strip().splitlines()[-1]
            if last != f"blstm_infer launches: {n_launch}":
                failures.append(f"{job}: last line {last!r}, expected "
                                f"{n_launch} row-5 launches")
            radius = job.split()[-1]
            rows = read_results(os.path.join(procs[job][0], "results.csv"))
            want_rows = golden["samples" if cli == "eval_syn"
                               else "edge_samples"]
            worst = {"dB": 0.0, "stoi": 0.0, "pesq": 0.0}
            for name in sorted(os.listdir(test_dir)):
                got, want = rows[name], want_rows[f"{radius}/{name}"]
                if cli == "eval_syn":
                    (k, v), = jax_base["samples"][f"{radius}/{name}"].items()
                    if not abs(float(got[k]) - v) <= PARITY_TOL_DB:
                        failures.append(f"{job} {name} {k} {got[k]} vs "
                                        f"JAX {v:.5f}")
                for col, w in want.items():
                    kind = col if col in ("stoi", "pesq") else (
                        col[:4] if col in ("stoi_in", "pesq_in") else "dB")
                    if col == "n_tgt_speakers":
                        if int(got[col]) != w:
                            failures.append(f"{job} {name} {col}")
                        continue
                    err = abs(float(got[col]) - w)
                    worst[kind] = max(worst[kind], err)
                    tol = PARITY_TOL_DB if kind == "dB" else \
                        EVAL_PERCEPTUAL_TOL
                    if not err <= tol:
                        failures.append(f"{job} {name} {col} {got[col]} vs "
                                        f"JAX {w} (tol {tol})")
            log(f"phase 27 {job}: {len(rows)} samples in {walls[job]:.1f} s "
                f"wall (process start and library load included); {last}; "
                f"worst |port - JAX| {worst['dB']:.2e} dB, STOI "
                f"{worst['stoi']:.2e}, PESQ {worst['pesq']:.2e}")
        reused = os.path.exists(lib) and os.stat(lib).st_ino == built
        log(f"phase 27: the CLIs loaded phase 2's library {lib}, none "
            f"built one: {reused}")
        if not reused:
            failures.append(f"a CLI built the kernel library anew ({lib})")
        if failures:
            fail("eval CLIs: " + "; ".join(failures))
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return walls


def wrapper_chunk_ms(wrapper, n, rng):
    """ms per ModelWrapper.feed, host clock, n chunks after 10."""
    cfg = wrapper.cfg
    wrapper.reset()
    win = torch.from_numpy(rng.standard_normal(
        (1, cfg.num_ch, cfg.n_fft)).astype(np.float32)).to(wrapper.device)
    for _ in range(10):
        wrapper.feed(win)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        wrapper.feed(win)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e3


def feed_ops(wrapper, n, rng):
    """Device operations (kernels, copies, fills) a ModelWrapper.feed
    enqueues, from torch.profiler's CUDA activity over n chunks after 3
    (CUPTI now and then drops a record, so this can read a little low)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = wrapper.cfg
    win = torch.from_numpy(rng.standard_normal(
        (1, cfg.num_ch, cfg.n_fft)).astype(np.float32)).to(wrapper.device)
    for _ in range(3):
        wrapper.feed(win)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            wrapper.feed(win)
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events()) / n


def cudnn_blstm(params, c, dev):
    """torch.nn.LSTM(bidirectional) with row 5's weights (the library
    yardstick; the port never calls it)."""
    lstm = torch.nn.LSTM(c, ROW5_H, batch_first=True,
                         bidirectional=True).to(dev)
    with torch.no_grad():
        for sfx, d in (("", "fwd"), ("_reverse", "bwd")):
            getattr(lstm, f"weight_ih_l0{sfx}").copy_(params[d]["w_ih"].T)
            getattr(lstm, f"weight_hh_l0{sfx}").copy_(params[d]["w_hh"].T)
            getattr(lstm, f"bias_ih_l0{sfx}").copy_(params[d]["b"])
            getattr(lstm, f"bias_hh_l0{sfx}").zero_()
    return lstm


def phase28_times(dev, rk, cases, net5, slab_net, card, walls):
    """Row 5's whole function at ROW5_SHAPES (CUDA events; one launch, the
    projection included), its plain version, its bound, cuDNN's
    bidirectional LSTM with its projection; ms a chunk of ModelWrapper on
    row 5 and on the slab kernels, in turns, and of
    streaming_inference_scan; the offline forward a golden; the eval CLIs'
    seconds. Returns the kernel line's
    numbers at the serving main path's shape."""
    from sound_bubble_tpu_torch.evaluation import load_testcase, one_hot
    from sound_bubble_tpu_torch.ops.stft import mod_pad
    from sound_bubble_tpu_torch.runtime.streaming import (
        ModelWrapper, streaming_inference_scan)

    rows = {}
    with torch.no_grad():
        for name, (params, x) in cases.items():
            r, t_len, c = x.shape
            lstm = cudnn_blstm(params, c, dev)
            lib_err = float((lstm(x)[0] - rk.blstm_infer(params, x))
                            .abs().max())
            for _ in range(10):
                rk.blstm_infer(params, x)
            kernel_ms = cuda_ms(lambda: rk.blstm_infer(params, x), 200)
            rk.blstm_infer_ref(params, x)
            plain_ms = cuda_ms(lambda: rk.blstm_infer_ref(params, x), 3)
            lstm(x)
            lib_ms = cuda_ms(lambda: lstm(x), 200)
            bound_ms, bound_by = row5_bound_ms(t_len, r, c, ROW5_H)
            rows[name] = {"ms": kernel_ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": lib_ms}
            tile = rk.row_tile(r, c, torch.cuda.get_device_properties(dev)
                               .multi_processor_count)
            log(f"phase 28 row 5 {name} [R={r}, T={t_len}, C={c}] on "
                f"{card}: whole function (one launch, %d rows a block, %d "
                f"blocks) {kernel_ms:.4f} ms (200 calls), plain "
                f"{plain_ms:.3f} ms, bound {bound_ms:.6f} ms ({bound_by}); "
                f"cuDNN bidirectional LSTM {lib_ms:.4f} ms (max-abs "
                f"{lib_err:.1e} from the port)" % tile)

        rng = np.random.default_rng(SEED)
        row5_w = ModelWrapper(net5, device=dev)
        slab_w = ModelWrapper(slab_net, device=dev)
        turns = [("row5", row5_w), ("slab", slab_w), ("slab", slab_w),
                 ("row5", row5_w)]
        chunk_ms = {"row5": [], "slab": []}
        for name, wrap in turns:
            chunk_ms[name].append(wrapper_chunk_ms(wrap, 100, rng))
        ops = {name: feed_ops(wrap, 10, rng)
               for name, wrap in (("row5", row5_w), ("slab", slab_w))}
        cfg = net5.cfg
        _, mixture, _, _, _ = load_testcase(
            os.path.join(GOLDENS, "syn_1m", "00002"), 24000, 1.0)
        xp, _ = mod_pad(torch.from_numpy(mixture)[None],
                        cfg.stft_chunk_size, (0, cfg.stft_pad_size))
        n_clip = (xp.shape[-1] - cfg.stft_pad_size) // cfg.stft_chunk_size
        scan_ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            streaming_inference_scan(net5, xp, cfg.stft_chunk_size,
                                     cfg.stft_pad_size,
                                     dis_embed=one_hot(1.0), device=dev)
            torch.cuda.synchronize()
            scan_ms.append((time.perf_counter() - t) / n_clip * 1e3)
        xd = xp[..., :mixture.shape[-1]].to(dev)
        offline_ms = {}
        for name, net in (("row5", net5), ("slab", slab_net)):
            inputs = {"mixture": xd, "dis_embed": torch.tensor(
                one_hot(1.0), device=dev)}
            net(inputs)
            offline_ms[name] = cuda_ms(lambda: net(inputs), 10)
    log(f"phase 28 serving on {card}: ModelWrapper.feed ms a chunk (host "
        f"clock, 100 chunks, in turns) row 5 {np.round(chunk_ms['row5'], 4)}"
        f", slab kernels {np.round(chunk_ms['slab'], 4)}; device operations "
        f"a chunk (torch.profiler, 10 chunks) row 5 {ops['row5']:.1f}, slab "
        f"{ops['slab']:.1f}; "
        f"streaming_inference_scan (one CUDA graph of a chunk, {n_clip} "
        f"replays, capture included) {np.round(scan_ms, 4)} ms a chunk; "
        f"offline Net(pad=True) forward of a 2 s golden (CUDA events) row 5 "
        f"{offline_ms['row5']:.3f} ms, slab {offline_ms['slab']:.3f} ms")
    log(f"phase 28 eval CLIs on {card}: wall seconds a golden (3 a run, "
        f"4 runs at once; process start, kernel build, STOI and PESQ on "
        f"the host included) "
        f"{ {k: round(v / 3, 2) for k, v in walls.items()} }")
    return rows["serve1"]


# ---- phases 29-31: data generation (`datagen/`): the campaign pool's RIRs
# and a training batch on the card, and the sample-dir generators end to end

# phase 29's cut of the flagship recipe's pool (3000 scenarios; sr 24000,
# rir_len 12000, image order U{10..32}, the background-noise slot): 8
# scenarios. Device RIRs against the host's, each scenario within a
# relative L2 error of 0.02 (tests/test_campaign.py holds JAX's two methods
# to the same bar: the host bins each image's delay to 1/8 sample)
POOL_CUT = 8
POOL_ORDER_RANGE = (10, 32)
POOL_RIR_LEN = 12000
POOL_REL_L2 = 0.02
# phase 30: the card's batch against the same call on the CPU (float32 FFT
# convolutions of another library), / peak; the mixture before augmentation
# on its target SNR (tests/test_on_device_datagen.py's bar)
BATCH_REL_TOL = 1e-4
SNR_TOL_DB = 1e-3
# phase 31: the generators' cuts (--max_order_max 72 and 40 by default)
GEN_ARGS = ["--n_outputs_train", "6", "--n_outputs_test", "3",
            "--duration", "2.5", "--n_workers", "1", "--max_order_max", "20"]
EVAL_SET_ARGS = ["--n", "3", "--duration", "2.5", "--voice", "harmonic",
                 "--max_order_max", "20"]
GEN_TIMEOUT_S = 300


def phase29_device_pool(dev, card):
    """`campaign.build_pool(method="device")` on the card at the flagship
    recipe's shapes, cut to POOL_CUT scenarios, against `method="host"` for
    the same seed: geometry and masks equal, each scenario's RIRs within
    POOL_REL_L2. Returns the device pool."""
    from sound_bubble_tpu_torch.datagen import campaign

    with open(os.path.join(RUN_DIR, "train_stream_args.json")) as fh:
        recipe = json.load(fh)
    kw = dict(seed=SEED, sr=24000, rir_len=POOL_RIR_LEN,
              order_range=POOL_ORDER_RANGE, bg_noise=recipe["bg_noise"] > 0,
              verbose=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    pool, radius = campaign.build_pool(POOL_CUT, method="device", device=dev,
                                       **kw)
    device_s = time.perf_counter() - t
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t = time.perf_counter()
    host, host_radius = campaign.build_pool(POOL_CUT, **kw)
    host_s = time.perf_counter() - t
    if sorted(pool) != sorted(host) or not np.array_equal(radius,
                                                          host_radius):
        fail("device and host pools hold other arrays or radii")
    for k in pool:
        if k != "rirs" and not np.array_equal(pool[k], host[k]):
            fail(f"device and host pools: {k} differs")
    d, h = pool["rirs"].astype(np.float64), host["rirs"].astype(np.float64)
    rel = [float(np.linalg.norm(d[i] - h[i]) / np.linalg.norm(d[i]))
           for i in range(POOL_CUT)]
    log(f"phase 29 device pool on {card}: build_pool(method='device') at "
        f"sr 24000, rir_len {POOL_RIR_LEN}, order_range {POOL_ORDER_RANGE}, "
        f"bg_noise {kw['bg_noise']}, {POOL_CUT} scenarios (cut from 3000), "
        f"rirs {pool['rirs'].shape}: device {device_s / POOL_CUT:.3f} s a "
        f"scenario ({device_s:.2f} s, the first call included; peak "
        f"{peak_gb:.2f} GB, chunk 2048), host {host_s / POOL_CUT:.3f} s a "
        f"scenario ({host_s:.2f} s); geometry and masks equal; relative L2 "
        f"device vs host per scenario {['%.2e' % r for r in rel]} (tol "
        f"{POOL_REL_L2})")
    if not max(rel) <= POOL_REL_L2:
        fail(f"device RIRs disagree with the host's: {max(rel)} > "
             f"{POOL_REL_L2}")

    # the two renderers alone on one scenario at the top order (the device
    # sums every image slot, padded to the top order's count, either way)
    from sound_bubble_tpu_torch.datagen.ism import shoebox_images

    n_img = len(shoebox_images([6, 6, 3], [3, 3, 1.5], max(
        POOL_ORDER_RANGE[1], campaign.BG_ORDER))[0])
    t = time.perf_counter()
    sc = campaign.sample_scenario(np.random.default_rng(SEED), 1.0, 2,
                                  POOL_ORDER_RANGE[1], n_img,
                                  bg_noise=kw["bg_noise"])
    geom_s = time.perf_counter() - t
    args = [sc[k] for k in ("images", "n_refl", "img_mask", "mics", "rho")]
    trim = sc["delay_trim"] if kw["bg_noise"] else None
    rir_kw = dict(fs=24000, rir_len=POOL_RIR_LEN)
    t = time.perf_counter()
    campaign.rirs_host_fast(*args, delay_trim=trim, **rir_kw)
    host_rir_s = time.perf_counter() - t
    dargs = [torch.as_tensor(a, device=dev) for a in args]
    dtrim = None if trim is None else torch.as_tensor(trim, device=dev)

    def render():
        campaign.rirs_on_device(*dargs, delay_trim=dtrim, **rir_kw)

    render()
    device_rir_ms = cuda_ms(render, 3)
    s_slots, m_mics = pool["rirs"].shape[1:3]
    terms = s_slots * m_mics * n_img * (POOL_RIR_LEN // 2 + 1)
    log(f"  one scenario at order {POOL_ORDER_RANGE[1]} ({n_img} image "
        f"slots, {terms:.3e} phase terms on the card): geometry "
        f"{geom_s:.3f} s (host), rirs_host_fast {host_rir_s:.3f} s (host, "
        f"one call), rirs_on_device {device_rir_ms:.2f} ms (CUDA events, 3 "
        f"calls after one)")
    return pool


def phase30_device_batch(dev, pool, card):
    """`on_device.make_training_batch` on the card at the recipe's batch
    (B x 2.5 s, B = the pool's scenarios, every slot of the pool, formant
    voices), draws from a seeded generator on the card: held against the
    same call on the CPU, and the mixture before augmentation against its
    target SNR; ms per batch."""
    from sound_bubble_tpu_torch.datagen import on_device as od
    from sound_bubble_tpu_torch.datagen.voice import formant_voices

    with open(os.path.join(RUN_DIR, "train_stream_args.json")) as fh:
        recipe = json.load(fh)
    n = int(recipe["clip_seconds"] * 24000)
    rirs = torch.from_numpy(pool["rirs"]).to(dev)
    b, s, m, _ = rirs.shape
    n_near = 1          # slot 0 holds a source in every scenario
    gen = torch.Generator(device=dev).manual_seed(SEED)
    voices = formant_voices(gen, (b, s), n, 24000, device=dev)
    lo, hi = recipe["snr_range"]
    target = lo + (hi - lo) * torch.rand(b, generator=gen, device=dev)
    draws = od.training_batch_draws(gen, b, s, m, n, device=dev)
    inputs, targets = od.make_training_batch(voices, rirs, n_near, target,
                                             draws)

    def cpu(tree):
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        return tree.cpu()

    want_in, want_tg = od.make_training_batch(
        voices.cpu(), rirs.cpu(), n_near, target.cpu(), cpu(draws))
    errs = {k: float((got.cpu() - want).abs().max() / want.abs().max())
            for k, got, want in (("mixture", inputs["mixture"],
                                  want_in["mixture"]),
                                 ("target", targets["target"],
                                  want_tg["target"]))}
    premix = od.peak_scale(od.render_sources(voices, rirs), draws["peak"])
    near, far = premix[:, :n_near].sum(1), premix[:, n_near:].sum(1)
    _, mixture = od.mix_to_target_snr(near, far, target)
    ref = near[:, 0].double().cpu().numpy()
    noise = (mixture - near)[:, 0].double().cpu().numpy()
    achieved = 10 * np.log10(np.sum(ref ** 2, -1) / np.sum(noise ** 2, -1))
    snr_err = float(np.abs(achieved - target.double().cpu().numpy()).max())
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (inputs["mixture"], targets["target"]))

    def batch():
        od.make_training_batch(voices, rirs, n_near, target, draws)

    def batch_with_draws():
        d = od.training_batch_draws(gen, b, s, m, n, device=dev)
        od.make_training_batch(voices, rirs, n_near, target, d)

    batch()
    batch_ms = cuda_ms(batch, 10)
    batch_with_draws()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        batch_with_draws()
    torch.cuda.synchronize()
    draws_ms = (time.perf_counter() - t) / 10 * 1e3
    log(f"phase 30 on-device batch on {card}: make_training_batch, voices "
        f"{tuple(voices.shape)} (formant_voices), rirs {tuple(rirs.shape)} "
        f"(phase 29's pool), n_near {n_near}: card vs CPU max-abs / peak "
        f"{errs} (tol {BATCH_REL_TOL}); mix_to_target_snr's mixture vs its "
        f"target, worst {snr_err:.2e} dB (tol {SNR_TOL_DB}); "
        f"{batch_ms:.3f} ms a batch (CUDA events, 10 batches), "
        f"{draws_ms:.3f} ms with its draws (host clock, 10 batches)")
    if not (finite and max(errs.values()) <= BATCH_REL_TOL):
        fail(f"the card's batch disagrees with the CPU's: {errs}")
    if not snr_err <= SNR_TOL_DB:
        fail(f"mix_to_target_snr missed its target by {snr_err} dB")


def write_corpus(root, dev):
    """Six speaker dirs of three 2 s formant-voice wavs at 48 kHz and the
    split json (four speakers train, two test). Returns the split's path."""
    from sound_bubble_tpu_torch.data.audio_io import write_audio_file
    from sound_bubble_tpu_torch.datagen.voice import formant_voices

    gen = torch.Generator(device=dev).manual_seed(SEED)
    voices = formant_voices(gen, (6, 3), 2 * 48000, 48000,
                            device=dev).cpu().numpy()
    speakers = [f"p{225 + i}" for i in range(6)]
    for spk, clips in zip(speakers, voices):
        os.makedirs(os.path.join(root, spk))
        for k, clip in enumerate(clips):
            write_audio_file(os.path.join(root, spk, f"{spk}_{k:03d}.wav"),
                             0.5 * clip[None], 48000)
    split = os.path.join(root, "split.json")
    with open(split, "w") as fh:
        json.dump({"train": speakers[:4], "test": speakers[4:]}, fh)
    return split


def phase31_generators(dev, ls, card):
    """The sample-dir generators end to end: a mini-corpus, then
    `generate_adaptive_dataset` (6 train and 3 test samples) and
    `make_eval_set` (3 a radius) as subprocesses at once; `train_pt` at the
    flagship's width for one epoch on the generated dirs (slab kernels);
    `eval_syn` with the flagship on each radius of the eval set."""
    from sound_bubble_tpu_torch import eval_syn

    tmp = tempfile.mkdtemp(prefix="chip_smoke_datagen_")
    procs = {}
    try:
        corpus = os.path.join(tmp, "corpus")
        split = write_corpus(corpus, dev)
        data, evals = os.path.join(tmp, "syn_1m"), os.path.join(tmp, "eval")
        jobs = {"generate_adaptive_dataset": [corpus, data, "--split_path",
                                              split, *GEN_ARGS],
                "make_eval_set": ["--out", evals, *EVAL_SET_ARGS]}
        walls, t0 = {}, time.perf_counter()
        for job, argv in jobs.items():
            with open(os.path.join(tmp, job + ".log"), "w") as log_f:
                procs[job] = subprocess.Popen(
                    [sys.executable, "-m", f"sound_bubble_tpu_torch.{job}",
                     *argv], cwd=REPO, stdout=log_f,
                    stderr=subprocess.STDOUT)
        while len(walls) < len(procs):
            if time.perf_counter() - t0 > GEN_TIMEOUT_S:
                fail(f"generators still running after {GEN_TIMEOUT_S} s")
            for job, proc in procs.items():
                if job not in walls and proc.poll() is not None:
                    walls[job] = time.perf_counter() - t0
            time.sleep(0.2)
        for job, proc in procs.items():
            if proc.returncode != 0:
                with open(os.path.join(tmp, job + ".log")) as log_f:
                    fail(f"{job} exited {proc.returncode}:\n"
                         f"{log_f.read()[-3000:]}")
        made = {"generate_adaptive_dataset": [
                    os.path.join(data, sub, d) for sub in ("train", "test")
                    for d in sorted(os.listdir(os.path.join(data, sub)))],
                "make_eval_set": [
                    os.path.join(evals, f"syn_{r}", "test", d)
                    for r, _ in RADII for d in sorted(os.listdir(
                        os.path.join(evals, f"syn_{r}", "test")))]}
        for job, dirs in made.items():
            if len(dirs) != 9 or not all(os.path.exists(os.path.join(
                    d, "metadata.json")) for d in dirs):
                fail(f"{job} wrote {len(dirs)} sample dirs, expected 9")
        log(f"phase 31 generators on {card}: generate_adaptive_dataset "
            f"{' '.join(GEN_ARGS)} on a 6-speaker formant-voice corpus: "
            f"9 samples in {walls['generate_adaptive_dataset']:.2f} s "
            f"({walls['generate_adaptive_dataset'] / 9:.3f} s a sample, "
            f"process start included); make_eval_set "
            f"{' '.join(EVAL_SET_ARGS)}: 9 samples in "
            f"{walls['make_eval_set']:.2f} s "
            f"({walls['make_eval_set'] / 9:.3f} s a sample), both at once")

        # train_pt on the generated dirs (slab kernels)
        with open(TRAIN_CONFIG) as fh:
            cfg = json.load(fh)
        point_at_scenes(cfg, {"train": [os.path.join(data, "train")],
                              "val": [os.path.join(data, "test")]})
        cfg["num_workers"] = 2
        n_scans = 3 * cfg["pl_module_args"]["model_params"]["B"]
        steps = math.ceil(6 / cfg["batch_size"])
        val_batches = math.ceil(3 / cfg["eval_batch_size"])
        run_dir = os.path.join(tmp, "run")
        _, train_s, fwd_n, bwd_n = run_train_pt(
            cfg, os.path.join(tmp, "config.json"), run_dir, 1, ls)
        want = ((steps + val_batches) * n_scans, steps * n_scans)
        with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
            logged = [json.loads(line) for line in fh]
        losses = [e[k] for e in logged for k in ("train/loss", "val/loss")]
        log(f"  train_pt on the generated dirs: 1 epoch x {steps} steps + "
            f"{val_batches} val batch in {train_s:.2f} s; slab launches fwd "
            f"{fwd_n}, bwd {bwd_n} (expected {want[0]}, {want[1]}); losses "
            f"(train, val) {losses}")
        if (fwd_n, bwd_n) != want:
            fail(f"slab launches {(fwd_n, bwd_n)}, expected {want}")
        if len(logged) != 1 or not np.isfinite(losses).all():
            fail(f"run log on the generated dirs: {logged}")

        # eval_syn with the flagship on the fresh eval set
        means, t = {}, time.perf_counter()
        for radius, threshold in RADII:
            out = os.path.join(tmp, f"eval_out_{radius}")
            with contextlib.redirect_stdout(io.StringIO()):
                eval_syn.main(eval_syn.parser().parse_args(
                    [os.path.join(evals, f"syn_{radius}", "test"), RUN_DIR,
                     out, "--distance_threshold", str(threshold)]))
            rows = read_results(os.path.join(out, "results.csv"))
            vals = [float(r["sisdri"]) for r in rows.values()
                    if r.get("sisdri")]
            if len(rows) != 3 or not vals or not np.isfinite(vals).all():
                fail(f"eval_syn on the {radius} eval set: {rows}")
            means[radius] = float(np.mean(vals))
        eval_s = time.perf_counter() - t
        log(f"  eval_syn ({os.path.relpath(RUN_DIR, REPO)}) on the fresh "
            f"eval set, 3 samples a radius, in {eval_s:.2f} s: mean SI-SDRi "
            + ", ".join(f"{r} {v:+.3f} dB" for r, v in means.items()))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)

# ---- phase 32: the graphed streaming step (`runtime/fast_path.py`):
# `fused_scan_stream` (JAX's whole-signal harness) and `FusedStreamer.feed`,
# one captured CUDA graph of the step replayed a chunk

# chunks of phase 32's ms-a-chunk runs on a seeded signal a net: the eager
# step and the graphed feed, and a whole fused_scan_stream call (as many
# chunks as the 9 goldens have); the first chunks of syn_1m/00002 held bit
# for bit on rows 2-4 and the per-block route
STEP_TIME_CHUNKS = 500
SCAN_TIME_CHUNKS = 2250
SCAN_HEAD_CHUNKS = 20


def golden_windows(cfg, mixture, dev):
    """(windows [n, 1, M, chunk + pad] on dev, mod) of one mixture [M, N],
    padded and cut as `evaluation.run_testcase` cuts them."""
    from sound_bubble_tpu_torch.ops.stft import mod_pad

    chunk, pad = cfg.stft_chunk_size, cfg.stft_pad_size
    x, mod = mod_pad(torch.from_numpy(np.asarray(mixture, np.float32))[None],
                     chunk, (cfg.stft_back_pad, pad))
    x = x.to(dev)
    n = (x.shape[-1] - pad) // chunk
    return torch.stack([x[..., k * chunk:k * chunk + chunk + pad]
                        for k in range(n)]), mod


def eager_stream(fs, windows):
    """The eager step (`_step_impl`, no graph) of a fresh state over the
    windows."""
    state, outs = fs._make_state(), []
    with torch.no_grad():
        for w in windows:
            out, state = fs._step_impl(w, state, fs.film)
            outs.append(out)
    return torch.cat(outs, dim=-1)


def stack_counts(sk):
    names = ("launches", "conv_launches", "attn_launches",
             "conv_attn_launches")
    return {n: getattr(sk.gridnet_stack_step, n) for n in names}


def phase32_fused_scan(dev, net, edge_net, attn_nets, card):
    """The 9 goldens through `fused_scan_stream` on the flagship (row 1)
    against the JAX numbers; the first chunks of syn_1m/00002 through the
    Orange Pi edge net (row 2), both attention nets (rows 3 and 4) and their
    per-block route: `fused_scan_stream` and the graphed `feed` bit-equal to
    the eager step; ms a chunk of the three, host clock, in turns. Returns
    {row: launches of its kernel in the fused_scan_stream runs}."""
    from sound_bubble_tpu_torch.evaluation import load_testcase, one_hot
    from sound_bubble_tpu_torch.metrics.metrics import (
        Metrics, compute_decay)
    from sound_bubble_tpu_torch.ops.kernels import stack_kernel as sk
    from sound_bubble_tpu_torch.runtime.fast_path import (
        FusedStreamer, fused_scan_stream)

    with open(JAX_BASELINE) as fh:
        jax_base = json.load(fh)
    si_sdr_i = Metrics("si_sdr_i")
    cfg = net.cfg
    failures, n_chunks, scan_s = [], 0, 0.0
    for c in stack_counts(sk):
        setattr(sk.gridnet_stack_step, c, 0)
    for radius, threshold in RADII:
        rdir = os.path.join(GOLDENS, f"syn_{radius}")
        for name in sorted(os.listdir(rdir)):
            _, mixture, gt, tgt, _ = load_testcase(
                os.path.join(rdir, name), 24000, threshold)
            windows, mod = golden_windows(cfg, mixture, dev)
            torch.cuda.synchronize()
            t = time.perf_counter()
            y = fused_scan_stream(net, windows, one_hot(threshold),
                                  device=dev)
            torch.cuda.synchronize()
            scan_s += time.perf_counter() - t
            n_chunks += len(windows)
            out = y[0, :, :y.shape[-1] - mod].cpu().numpy()
            if out.shape != (cfg.num_src, mixture.shape[-1]) or \
                    not np.isfinite(out).all():
                fail(f"fused_scan_stream {radius}/{name}: output "
                     f"{out.shape}, finite {np.isfinite(out).all()}")
            if tgt:
                key, v = "sisdri", float(si_sdr_i(est=out, gt=gt,
                                                   mix=mixture[0:1]))
            else:
                key, v = "decay", float(compute_decay(est=out,
                                                      mix=mixture[0:1]))
            want = jax_base["samples"][f"{radius}/{name}"][key]
            log(f"  fused_scan_stream {radius}/{name}: {key} {v:+.5f} dB "
                f"(JAX {want:+.5f})")
            if not abs(v - want) <= PARITY_TOL_DB:
                failures.append(f"{radius}/{name} {key} {v:.5f} vs JAX "
                                f"{want:.5f}")
    counts = stack_counts(sk)
    log(f"phase 32 fused_scan_stream, flagship (row 1): 9 goldens, "
        f"{n_chunks} chunks in {scan_s:.3f} s on {card} "
        f"({scan_s / n_chunks * 1e3:.4f} ms a chunk, host clock, the "
        f"streamer's set-up and capture included); stack kernel launches "
        f"{counts}")
    if failures:
        fail(f"fused_scan_stream goldens (tol {PARITY_TOL_DB} dB): "
             + "; ".join(failures))
    if counts != {c: n_chunks if c == "launches" else 0 for c in counts}:
        fail(f"fused_scan_stream launched {counts} for {n_chunks} chunks")
    scan_launches = {1: n_chunks}

    # rows 2-4 and the per-block route: the graph against the eager step
    _, mixture, _, _, _ = load_testcase(
        os.path.join(GOLDENS, "syn_1m", "00002"), 24000, 1.0)
    routes = [("flagship", 1, net, True), ("edge", 2, edge_net, True),
              ("attn flagship", 3, attn_nets["flagship"], True),
              ("attn orangpi", 4, attn_nets["orangpi"], True),
              ("attn flagship per-block", 1, attn_nets["flagship"], False),
              ("attn orangpi per-block", 2, attn_nets["orangpi"], False)]
    rng = np.random.default_rng(SEED + 32)
    for name, row, rnet, in_kernel in routes:
        rcfg = rnet.cfg
        dis = one_hot(1.0)
        windows, _ = golden_windows(rcfg, mixture, dev)
        windows = windows[:SCAN_HEAD_CHUNKS]
        counter = ("conv_" if rcfg.conv_lstm else "") + (
            "attn_launches" if row in (3, 4) else "launches")
        per_chunk = 1 if in_kernel else rcfg.B
        eager = eager_stream(FusedStreamer(rnet, dis, device=dev,
                                           attn_in_kernel=in_kernel), windows)
        before = stack_counts(sk)[counter]
        scan = fused_scan_stream(rnet, windows, dis, device=dev,
                                 attn_in_kernel=in_kernel)
        torch.cuda.synchronize()
        grew = stack_counts(sk)[counter] - before
        fs = FusedStreamer(rnet, dis, device=dev, attn_in_kernel=in_kernel)
        with torch.no_grad():
            fed = torch.cat([fs.feed(w) for w in windows], dim=-1)
        same = (torch.equal(scan, eager), torch.equal(fed, eager))
        log(f"  {name} (row {row}{'' if in_kernel else ' a block'}), "
            f"first {len(windows)} chunks of syn_1m/00002: "
            f"fused_scan_stream bit-equal to the eager step {same[0]}, "
            f"graphed feed {same[1]}; {counter} +{grew}")
        if not all(same):
            fail(f"{name}: the graphed step differs from the eager step: "
                 f"max-abs {float((scan - eager).abs().max()):.3e} (scan), "
                 f"{float((fed - eager).abs().max()):.3e} (feed)")
        if grew != per_chunk * len(windows):
            fail(f"{name}: fused_scan_stream launched {counter} {grew} "
                 f"times for {len(windows)} chunks")
        if in_kernel and row > 1:
            scan_launches[row] = grew

        # ms a chunk in turns: eager, feed, scan, scan, feed, eager
        x = torch.from_numpy(rng.standard_normal(
            (1, rcfg.num_ch, rcfg.stft_back_pad + rcfg.stft_pad_size
             + rcfg.stft_chunk_size * SCAN_TIME_CHUNKS)).astype(
                 np.float32)).to(dev)
        chunk = rcfg.stft_chunk_size
        windows = torch.stack([x[..., k * chunk:k * chunk + rcfg.n_fft]
                               for k in range(SCAN_TIME_CHUNKS)])
        steps = windows[:STEP_TIME_CHUNKS]
        fs.reset()
        with torch.no_grad():
            fs.feed(windows[0])

        def run_eager():
            eager_stream(fs, steps)

        def run_feed():
            with torch.no_grad():
                for w in steps:
                    fs.feed(w)

        def run_scan():
            fused_scan_stream(rnet, windows, dis, device=dev,
                              attn_in_kernel=in_kernel)

        runs = {"eager": (run_eager, STEP_TIME_CHUNKS),
                "feed": (run_feed, STEP_TIME_CHUNKS),
                "scan": (run_scan, SCAN_TIME_CHUNKS)}
        times = {k: [] for k in runs}
        for kind in ("eager", "feed", "scan", "scan", "feed", "eager"):
            fn, n = runs[kind]
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t) / n * 1e3)
        log(f"phase 32 times, {name}, on {card}, ms a chunk (host clock, "
            f"in turns): " + ", ".join(
                f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in times.items())
            + f" (eager: `_step_impl`, no graph, {STEP_TIME_CHUNKS} chunks;"
            f" feed: the graphed FusedStreamer.feed on device windows, "
            f"{STEP_TIME_CHUNKS} chunks; scan: one fused_scan_stream call "
            f"over {SCAN_TIME_CHUNKS} chunks, set-up and capture included)")
    return scan_launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, REPO)
    from sound_bubble_tpu_torch.evaluation import (
        load_testcase, one_hot, run_testcase)
    from sound_bubble_tpu_torch.metrics.metrics import Metrics, compute_decay
    from sound_bubble_tpu_torch.ops.kernels import _build
    from sound_bubble_tpu_torch.ops.kernels.stack_kernel import (
        gridnet_stack_step, gridnet_stack_step_ref, walk_plan)
    from sound_bubble_tpu_torch.ops.stft import mod_pad
    from sound_bubble_tpu_torch.runtime.fast_path import FusedStreamer
    from sound_bubble_tpu_torch.runtime.streaming import (
        ModelWrapper, streaming_inference)
    from sound_bubble_tpu_torch.utils import load_pretrained
    from tools.time_stack_kernels import graph_ms

    # a hang anywhere ends the run (non-zero) well inside its time limit
    faulthandler.dump_traceback_later(1000, exit=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. device
    card = card_line()
    log(f"phase 1 device: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} card(s)")

    # ---- 2. build (always: every run compiles the sources; later
    # processes of this run, phase 27's CLIs among them, reuse the library)
    t = time.perf_counter()
    _build.load_library(rebuild=True)
    log(f"phase 2 build: {time.perf_counter() - t:.2f} s\n{_build.build_log()}")

    # ---- 3. kernel vs plain, full width, flagship weights, 1 m FiLM
    net = load_pretrained(RUN_DIR, device=dev)
    cfg = net.cfg
    streamer = FusedStreamer(net, dis_embed=one_hot(1.0), device=dev)
    packed, (film_w, film_b) = streamer.packed, streamer.film
    F, D, H, B = cfg.n_freqs, cfg.D, cfg.H, cfg.B
    rng = np.random.default_rng(SEED)

    def draw(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    xs = [draw(F, D) for _ in range(5)]
    hk, ck = draw(B, F, H) * 0.5, draw(B, F, H) * 0.5
    hr, cr = hk, ck
    before = gridnet_stack_step.launches
    err = 0.0
    with torch.no_grad():
        for x in xs:
            xk, hk, ck = gridnet_stack_step(packed, x, hk, ck, film_w, film_b,
                                            eps=cfg.eps)
            xr, hr, cr = gridnet_stack_step_ref(packed, x, hr, cr, film_w,
                                                film_b, eps=cfg.eps)
            torch.cuda.synchronize()
            err = max(err, *[float((a - b).abs().max())
                             for a, b in ((xk, xr), (hk, hr), (ck, cr))])
    grew = gridnet_stack_step.launches - before
    log(f"phase 3 kernel vs plain: F={F} D={D} H={H} B={B}, 5 chained "
        f"steps, max-abs err {err:.3e} (tol {KERNEL_TOL}), launches +{grew}; "
        f"launch {walk_plan(F, D, H, B)}")
    if not err <= KERNEL_TOL:
        fail(f"kernel disagrees with its plain version: {err} > {KERNEL_TOL}")
    if grew != 5:
        fail(f"kernel launches grew by {grew}, expected 5")

    # ---- 4. serving: the goldens through FusedStreamer (the main path)
    with open(BASELINE) as fh:
        base = json.load(fh)
    with open(JAX_BASELINE) as fh:
        jax_base = json.load(fh)
    si_sdr_i = Metrics("si_sdr_i")
    results, failures, n_chunks = {}, [], 0
    gridnet_stack_step.launches = 0
    t = time.perf_counter()
    for radius, threshold in RADII:
        sisdris, decays = [], []
        rdir = os.path.join(GOLDENS, f"syn_{radius}")
        for name in sorted(os.listdir(rdir)):
            _, mixture, gt, tgt, _ = load_testcase(
                os.path.join(rdir, name), 24000, threshold)
            out = run_testcase(streamer, mixture, threshold)
            n_chunks += -(-mixture.shape[-1] // cfg.stft_chunk_size)
            if out.shape != (cfg.num_src, mixture.shape[-1]):
                fail(f"{radius}/{name}: output shape {out.shape}")
            if not np.isfinite(out).all():
                fail(f"{radius}/{name}: non-finite output")
            if tgt:
                key, v = "sisdri", float(si_sdr_i(est=out, gt=gt,
                                                   mix=mixture[0:1]))
                sisdris.append(v)
            else:
                key, v = "decay", float(compute_decay(est=out,
                                                      mix=mixture[0:1]))
                decays.append(v)
            want = jax_base["samples"][f"{radius}/{name}"][key]
            if not abs(v - want) <= PARITY_TOL_DB:
                failures.append(f"{radius}/{name} {key} {v:.5f} vs JAX "
                                f"{want:.5f} (tol {PARITY_TOL_DB} dB)")
        results[radius] = (float(np.mean(sisdris)), float(np.mean(decays)))
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    launches = gridnet_stack_step.launches
    log(f"phase 4 serving: 9 goldens, {n_chunks} chunks in {serve_s:.2f} s "
        f"({serve_s / n_chunks * 1e3:.3f} ms/chunk incl. metrics), stack "
        f"kernel launches {launches}")
    for radius, _ in RADII:
        sisdri, decay = results[radius]
        log(f"  goldens {radius}: SI-SDRi {sisdri:+.4f} dB (JAX fp32 "
            f"{jax_base['sisdri'][radius]:+.4f}), decay {decay:.4f} dB "
            f"(JAX fp32 {jax_base['decay'][radius]:.4f})")
    log(f"  for information, {os.path.basename(BASELINE)} (the reference's "
        f"own golden set, other audio than test_samples/): SI-SDRi "
        f"{base['sisdri']}, decay {base['decay']}")
    if failures:
        fail("goldens regression: " + "; ".join(failures))
    if launches != n_chunks:
        fail(f"stack kernel launched {launches} times for {n_chunks} chunks")

    # kernel path vs plain ModelWrapper path on the first 20 chunks
    _, mixture, _, _, _ = load_testcase(
        os.path.join(GOLDENS, "syn_1m", "00002"), 24000, 1.0)
    head = mixture[:, :20 * cfg.stft_chunk_size]
    fused = run_testcase(streamer, head, 1.0)
    xp, _ = mod_pad(torch.from_numpy(head)[None], cfg.stft_chunk_size,
                    (cfg.stft_back_pad, cfg.stft_pad_size))
    plain = streaming_inference(ModelWrapper(net, device=dev), xp,
                                cfg.stft_chunk_size, cfg.stft_pad_size,
                                dis_embed=one_hot(1.0))[0].cpu().numpy()
    rel = float(np.abs(fused - plain).max() / np.abs(plain).max())
    log(f"  kernel path vs ModelWrapper, 20 chunks: max-abs / peak "
        f"{rel:.3e} (tol {STREAM_REL_TOL})")
    if not rel <= STREAM_REL_TOL:
        fail(f"streaming paths disagree: {rel} > {STREAM_REL_TOL}")

    # ---- 5. times
    x, h0, c0 = xs[0], draw(B, F, H) * 0.5, draw(B, F, H) * 0.5
    with torch.no_grad():
        def kernel():
            gridnet_stack_step(packed, x, h0, c0, film_w, film_b, eps=cfg.eps)

        def plain_step():
            gridnet_stack_step_ref(packed, x, h0, c0, film_w, film_b,
                                   eps=cfg.eps)

        for _ in range(10):
            kernel()
        kernel_ms = cuda_ms(kernel, 200)
        plain_step()
        plain_ms = cuda_ms(plain_step, 3)
        kernel_graph_ms = graph_ms(kernel, 20)
        if kernel_graph_ms is None:
            fail("the stack kernel's call could not be captured in a CUDA "
                 "graph")
        streamer.reset()
        win = torch.from_numpy(
            rng.standard_normal((1, cfg.num_ch, cfg.n_fft)).astype(
                np.float32))
        for _ in range(10):
            streamer.feed(win)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(250):
            streamer.feed(win)
        torch.cuda.synchronize()
        chunk_ms = (time.perf_counter() - t) / 250 * 1e3
    bound_ms, bound_by = stack_step_bound_ms(B, F, D, H, film_w is not None)
    log(f"phase 5 times on {card}: stack kernel {kernel_ms:.4f} ms "
        f"(CUDA events, 200 launches; {kernel_graph_ms:.4f} ms a call as 20 "
        f"calls in one CUDA graph); plain version {plain_ms:.3f} ms "
        f"(3 calls); FusedStreamer.feed (graphed) {chunk_ms:.4f} ms per 8 "
        f"ms chunk "
        f"(host clock, 250 chunks); bound {bound_ms:.6f} ms ({bound_by}); "
        f"library_ms: none (no single PyTorch call computes the stack step)")

    # ---- 6. slab kernels vs plain
    from sound_bubble_tpu_torch.ops.kernels import lstm_slab as ls
    fwd_err, bwd_err = phase6_slab(dev, ls)

    # ---- 7. training (the main path of this phase: train_pt)
    (fwd_n, bwd_n), mod, batch = phase7_train(dev)

    # ---- 8. times
    slab_times, step_ms = phase8_times(dev, ls, mod, batch)
    log(f"phase 8 on {card}: ms per train step {step_ms:.2f}")

    # ---- 9. conv kernel vs plain (edge widths, ragged F)
    edge_net = load_pretrained(EDGE_RUN_DIR, device=dev)
    conv_err = phase9_conv_kernel(dev, edge_net)

    # ---- 10. edge serving (the main path of this phase: FusedStreamer)
    edge_streamer = FusedStreamer(edge_net, device=dev)
    conv_launches, _ = phase10_edge_serving(dev, edge_streamer)

    # ---- 11. edge training (train_pt, both stages)
    edge_mod, edge_batch = phase11_edge_train(dev, ls)

    # ---- 12. times
    conv_times = phase12_edge_times(dev, edge_streamer, edge_mod, edge_batch,
                                    card, ls)

    # ---- 13. mixed slab kernels vs plain, and their times
    mixed_fwd_err, mixed_bwd_err = phase13_mixed_slab(dev, ls)
    mixed_times, mixed_rows = mixed_slab_times(dev, ls, card)

    # ---- 14. one bf16 flagship step: kernel vs plain, vs the JAX golden
    phase14_bf16_step(dev, ls)
    bf16_step_times(dev, ls, mixed_rows, card)

    # ---- 15. the campaign trainer (the main path of the mixed kernels)
    (mixed_fwd_n, mixed_bwd_n), pool_s = phase15_train_stream(dev, ls, card)
    log(f"phase 15 on {card}: pool build {pool_s:.2f} s (host)")

    # ---- 16. the attention kernels vs plain (both nets' widths)
    attn_nets = {name: load_pretrained(d, device=dev)
                 for name, d in ATTN_RUN_DIRS.items()}
    attn_errs = phase16_attn_kernels(dev, attn_nets)

    # ---- 17. attention serving (the main path of rows 3 and 4)
    served = phase17_attn_serving(dev, attn_nets)

    # ---- 18. times
    attn_times = phase18_attn_times(dev, served, card)

    # ---- 19. training the attention flagship (train_pt)
    phase19_attn_train(dev, ls, card)

    # ---- 20. the custom-VJP route's kernels (rows 6-9) vs plain
    from sound_bubble_tpu_torch.ops.kernels import lstm_train_kernel as lk
    seq_errs = phase20_seq_kernels(dev, lk, ls)

    # ---- 21. fp32 training on the seq route (the main path of the fp32
    # instantiations: train_pt --lstm_scan seq)
    seq_fp32_n, seq_mod, seq_batch = phase21_seq_train(dev, lk, ls)

    # ---- 22. the bf16 recipe on the seq route (the main path of the mixed
    # instantiations: train_stream --lstm_scan seq)
    seq_mixed_n = phase22_seq_bf16(dev, lk, ls)

    # ---- 23. the edge finetune step on the seq route
    phase23_seq_edge(dev, lk)

    # ---- 24. times
    seq_times = phase24_seq_times(dev, lk, card, seq_mod, seq_batch)
    seq_src = "sound_bubble_tpu_torch/csrc/lstm_seq.cu"
    # row 6b has a source of its own; rows 7 and 9 are the backward walk
    bwd_src = "sound_bubble_tpu_torch/csrc/lstm_seq_bwd.cu"
    srcs = {("lstm_seq_fwd", True):
            "sound_bubble_tpu_torch/csrc/lstm_seq_fwd_mixed.cu",
            ("lstm_seq_bwd", False): bwd_src, ("lstm_seq_bwd", True): bwd_src,
            ("blstm_seq_bwd", False): bwd_src,
            ("blstm_seq_bwd", True): bwd_src}
    seq_tpu = "sound_bubble_tpu/ops/pallas/lstm_train_kernel.py"
    # the Pallas body of each row, and its mixed branch
    seq_lines = {"lstm_seq_fwd": (61, 75), "lstm_seq_bwd": (173, 204),
                 "blstm_seq_fwd": (360, 374), "blstm_seq_bwd": (410, 443)}
    # ---- 25. row 5, the fused inference BLSTM, vs its plain version
    from sound_bubble_tpu_torch.ops.kernels import lstm_kernel as rk
    cases5 = row5_cases(dev, {"flagship": net, "edge": edge_net})
    row5_err = phase25_row5_kernel(rk, cases5)

    # ---- 26. model-level serving on row 5 (the main path of row 5)
    row5_n, _, net5 = phase26_row5_serving(dev, rk, streamer)

    # ---- 27. the eval CLIs, offline, on row 5
    walls = phase27_eval_clis()

    # ---- 28. times
    row5_times = phase28_times(dev, rk, cases5, net5, net, card, walls)

    # ---- 29. the campaign pool's RIRs on the card (rirs_on_device)
    pool = phase29_device_pool(dev, card)

    # ---- 30. a training batch assembled on the card (on_device)
    phase30_device_batch(dev, pool, card)

    # ---- 31. the sample-dir generators, training and eval on their output
    phase31_generators(dev, ls, card)

    # ---- 32. fused_scan_stream and the graphed FusedStreamer.feed (the
    # main path of rows 1-4 as one captured CUDA graph of the step)
    scan_launches = phase32_fused_scan(dev, net, edge_net, attn_nets, card)

    seq_entries = [{
        "name": name + ("_mixed" if mixed else ""), "route": "cuda",
        "source": srcs.get((name, mixed), seq_src),
        "replaces": f"{seq_tpu}:{seq_lines[name][int(mixed)]}",
        "launches": (seq_mixed_n if mixed else seq_fp32_n)[i],
        "max_abs_err": seq_errs[name, mixed], **seq_times[name, mixed]}
        for mixed in (False, True) for i, name in enumerate(SEQ_NAMES)]
    # rows 8b and 6b: the walk of csrc/lstm_fwd32.cuh in its mixed mode;
    # rows 7 (nd = 1) and 9 (nd = 2): the backward walk
    kernels = {"lstm_seq_bwd": "seq_bbwd_kernel<64, float, float>, nd = 1",
               "lstm_seq_bwd_mixed": "seq_bbwd_kernel<64, bf16, bf16> / "
               "<64, bf16, float>, nd = 1",
               "blstm_seq_fwd_mixed": "seq_bfwd_mixed_kernel<64, bf16> / "
               "<64, float> (lstm_fwd32.cuh BSEQ, RND_SEQ)",
               "lstm_seq_fwd_mixed": "seq_fwd_mixed_kernel<64, bf16> / "
               "<64, float> (lstm_fwd32.cuh SEQ, RND_SEQ)",
               "blstm_seq_bwd": "seq_bbwd_kernel<64, float, float>, nd = 2",
               "blstm_seq_bwd_mixed": "seq_bbwd_kernel<64, bf16, bf16> / "
               "<64, bf16, float>, nd = 2"}
    for e in seq_entries:
        if e["name"] in kernels:
            e["kernel"] = kernels[e["name"]]

    slab_src = "sound_bubble_tpu_torch/csrc/lstm_slab.cu"
    slab_tpu = "sound_bubble_tpu/ops/pallas/lstm_train_slab.py"
    print(json.dumps({"kernels": [{
        "name": "gridnet_stack_step", "route": "cuda",
        "source": "sound_bubble_tpu_torch/csrc/stack_walk.cu",
        "replaces": "sound_bubble_tpu/ops/pallas/stack_kernel.py:243",
        "launches": launches, "scan_launches": scan_launches[1],
        "max_abs_err": err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}, {
        "name": "gridnet_stack_step_conv", "route": "cuda",
        "source": "sound_bubble_tpu_torch/csrc/stack_walk.cu",
        "replaces": "sound_bubble_tpu/ops/pallas/stack_kernel.py:393",
        "launches": conv_launches, "scan_launches": scan_launches[2],
        "max_abs_err": conv_err,
        **conv_times}, {
        "name": "lstm_slab_fwd", "route": "cuda", "source": slab_src,
        "replaces": f"{slab_tpu}:94", "launches": fwd_n,
        "max_abs_err": fwd_err, **slab_times["fwd"]}, {
        "name": "lstm_slab_bwd", "route": "cuda", "source": slab_src,
        "replaces": f"{slab_tpu}:229", "launches": bwd_n,
        "max_abs_err": bwd_err, **slab_times["bwd"]}, {
        "name": "lstm_slab_fwd_mixed", "route": "cuda", "source": slab_src,
        "kernel": ("slab_fwd_mixed_kernel<64, bf16> / <64, float> "
                   "(lstm_fwd32.cuh, RND_SLAB)"),
        "replaces": f"{slab_tpu}:125", "launches": mixed_fwd_n,
        "max_abs_err": mixed_fwd_err, **mixed_times["fwd"]}, {
        "name": "lstm_slab_bwd_mixed", "route": "cuda", "source": slab_src,
        "replaces": f"{slab_tpu}:271", "launches": mixed_bwd_n,
        "max_abs_err": mixed_bwd_err, **mixed_times["bwd"]}, {
        "name": "gridnet_stack_step_attn", "route": "cuda",
        "source": "sound_bubble_tpu_torch/csrc/stack_walk.cu",
        "replaces": "sound_bubble_tpu/ops/pallas/stack_kernel.py:354",
        "launches": served["flagship"][2],
        "scan_launches": scan_launches[3],
        "max_abs_err": attn_errs["flagship"], **attn_times["flagship"]}, {
        "name": "gridnet_stack_step_conv_attn", "route": "cuda",
        "source": "sound_bubble_tpu_torch/csrc/stack_walk.cu",
        "replaces": "sound_bubble_tpu/ops/pallas/stack_kernel.py:491",
        "launches": served["orangpi"][2],
        "scan_launches": scan_launches[4],
        "max_abs_err": attn_errs["orangpi"], **attn_times["orangpi"]},
        *seq_entries, {
        "name": "blstm_infer", "route": "cuda",
        "source": "sound_bubble_tpu_torch/csrc/lstm_infer.cu",
        "replaces": "sound_bubble_tpu/ops/pallas/lstm_kernel.py:53",
        "launches": row5_n, "max_abs_err": row5_err, **row5_times}]}),
        flush=True)
    print(card, flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
