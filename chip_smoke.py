"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's serving path (`sound_bubble_tpu_torch`) at the full width
of the flagship TF-GridNet (`runs/finetune_r5`: F=145, D=32, B=6, H=64):

1. device: the card's name and power limit, torch and CUDA versions;
2. build: the CUDA kernels, with nvcc's -Xptxas -v report;
3. kernel vs plain: `gridnet_stack_step` against `gridnet_stack_step_ref` on
   the card, 5 chained steps with the flagship's packed weights and FiLM;
4. serving: the 9 goldens of `test_samples/` streamed chunk by chunk through
   `FusedStreamer`; SI-SDRi and decay per sample held against the JAX
   package's fp32 numbers on the same audio
   (`runs/goldens_test_samples_jax.json`), per-radius means printed, and
   `runs/goldens_baseline.json` (the reference's own golden set, other
   audio) printed once for information; then the kernel path held against
   the plain `ModelWrapper` path;
5. times of the kernel, its plain version and one 8 ms chunk.

Exits non-zero on any failed check, and when no card or no package is found.
The last three lines are the JSON record of the kernels, the card's name and
power limit, and the device line.
"""
import faulthandler
import json
import os
import subprocess
import sys
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
PEAK_FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores
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


def stack_step_bound_ms(n_blocks, f, d, h, film):
    """Least time for one stack step on an H100: the larger of the bytes the
    step must move and its fp32 arithmetic over the fp32 rate. Both count the
    compact math, not the packed operands: the fused BLSTM packing pads each
    direction's input weights [D, 4H] to [D, 8H] and the recurrent weights
    into a block-diagonal [2H, 8H], and those zeros are no work the step
    needs. Bytes: weights read once, x/h0/c0 (and FiLM) read once, x/h0/c0
    written once."""
    weights = (2 * d                       # intra LayerNorm scale, bias
               + 2 * d * 4 * h             # fwd + bwd input weights
               + 2 * h * 4 * h             # fwd + bwd recurrent weights
               + 8 * h                     # fwd + bwd biases
               + 2 * h * d + d             # intra projection
               + 2 * d                     # inter LayerNorm
               + (d + h) * 4 * h + 4 * h   # inter LSTM
               + h * d + d)                # inter projection
    acts = 2 * (f * d + 2 * n_blocks * f * h)   # x, h0, c0 in and out
    film_floats = 2 * (n_blocks - 1) * f * d if film else 0
    n_bytes = 4 * (n_blocks * weights + acts + film_floats)
    per_block = (2 * 2 * f * d * 4 * h      # fwd + bwd input projections
                 + 2 * 2 * f * h * 4 * h    # fwd + bwd recurrence
                 + 2 * f * 2 * h * d        # intra projection
                 + 2 * f * (d + h) * 4 * h  # inter gates
                 + 2 * f * h * d)           # inter projection
    flops = n_blocks * per_block
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    log(f"bound: {n_bytes} B -> {t_bytes:.6f} ms at 3.35 TB/s; "
        f"{flops} FLOP -> {t_ops:.6f} ms at 67 TFLOP/s fp32; dependency "
        f"chain {n_blocks * (f + 1)} sequential cell updates")
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
        gridnet_stack_step, gridnet_stack_step_ref)
    from sound_bubble_tpu_torch.ops.stft import mod_pad
    from sound_bubble_tpu_torch.runtime.fast_path import FusedStreamer
    from sound_bubble_tpu_torch.runtime.streaming import (
        ModelWrapper, streaming_inference)
    from sound_bubble_tpu_torch.utils import load_pretrained

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

    # ---- 2. build
    t = time.perf_counter()
    _build.load_library()
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
        f"steps, max-abs err {err:.3e} (tol {KERNEL_TOL}), launches +{grew}")
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
        f"(CUDA events, 200 launches); plain version {plain_ms:.3f} ms "
        f"(3 calls); FusedStreamer.feed {chunk_ms:.4f} ms per 8 ms chunk "
        f"(host clock, 250 chunks); bound {bound_ms:.6f} ms ({bound_by}); "
        f"library_ms: none (no single PyTorch call computes the stack step)")

    print(json.dumps({"kernels": [{
        "name": "gridnet_stack_step", "route": "cuda",
        "source": "sound_bubble_tpu_torch/csrc/stack_step.cu",
        "replaces": "sound_bubble_tpu/ops/pallas/stack_kernel.py:243",
        "launches": launches, "max_abs_err": err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}), flush=True)
    print(card, flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
