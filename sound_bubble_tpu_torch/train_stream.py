"""The streaming training campaign: the port of `src/train_stream.py`.

    python -m sound_bubble_tpu_torch.train_stream --run_dir runs/campaign \
        --config syn_experiments/pretrain_stage.json \
        [--steps 20000] [--pool 3000] [--clip_seconds 3.0] [--bf16 | --no-bf16]
        [--device cuda|cpu] [--lstm_scan slab|seq] [--resume] ...

A pool of room acoustics is built once on the host (`datagen.campaign.
build_pool`: scenario geometry and image-source RIRs, numpy) and moved to
the device; every step then draws fresh sources, SNRs and scenarios on the
device (`campaign.batch_draws` from one `torch.Generator`, `make_batch`),
runs the model, the loss, the backward and the clipped Adam update. The
host supplies only the scenario indices.

The run dir has the reference layout (`config.json`, `checkpoints/last.pt`
and `best.pt` through the port's `save_checkpoint`, read unchanged by the
JAX package and the evaluation CLIs), `metrics.jsonl` and
`train_stream_args.json`, the run's recipe (precision, voice, batch, clip
length, SNR range, background-noise probability). `--resume` continues from
`last.pt` at step epoch * val_every, with the recorded precision and
background-noise probability whatever the flags say. `--bf16` (the default,
as in the JAX trainer) runs the mixed-precision step: the net's trunk in
bf16 (`compute_dtype="bf16"`) on the params cast by `utils.cast_bf16`, float32
master params, STFT front-end and loss. Every `val_every` steps a validation
on the validation pool with a fixed generator, the checkpoints, and the
plateau LR scheduler. One process on one device (`--device`, default
`cuda`; no card raises), TF32 off. `--lstm_scan` picks the LSTM scans'
kernel route as `train_pt` does (default from the JAX package's SB_LSTM_*
environment); it is part of the recorded recipe, and a `--resume` on the
other route is refused.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from sound_bubble_tpu_torch.datagen import campaign
from sound_bubble_tpu_torch.ops.rnn import SCANS, scan_from_env
from sound_bubble_tpu_torch.train.optim import ReduceLROnPlateau
from sound_bubble_tpu_torch.utils import (
    cast_bf16, import_attr, no_tf32, read_json, resolve_device)

VAL_SEED = 500


def build_module(cfg: dict, device, lstm_scan: str = "slab"):
    """The PLModule of the config (optimizer, scheduler, checkpoints, model
    handle), without its datasets, its LSTM scans on `lstm_scan`."""
    pl_args = dict(cfg["pl_module_args"])
    if "grad_clip" in cfg:
        pl_args["grad_clip"] = cfg["grad_clip"]
    return import_attr(cfg["pl_module"])(**pl_args, device=device,
                                         lstm_scan=lstm_scan)


def forward(net, model_in: dict, bf16: bool) -> torch.Tensor:
    """The net's output for model_in; with `bf16` the forward runs on the
    params cast to bf16 (the net's trunk must be `compute_dtype="bf16"`) and
    the output comes back in float32, gradients flowing to the float32
    params through the cast."""
    if not bf16:
        return net(model_in)["output"]
    params = cast_bf16(dict(net.named_parameters()))
    out = torch.func.functional_call(net, params, (model_in,))
    return out["output"].float()


def train_step(module, model_in: dict, gt: torch.Tensor, bf16: bool):
    """One optimizer step of `module` (forward, loss, backward, global-norm
    clip, Adam). Returns (loss, est) detached; the pre-clip gradient norm
    is `module.last_grad_norm`."""
    module.net.train()
    est = forward(module.net, model_in, bf16)
    loss = module._loss(est, gt)
    module.optimizer.zero_grad()
    loss.backward()
    module.last_grad_norm = module.optimizer.step()
    return loss.detach(), est.detach()


def _sisdr(e, g):
    e = e - e.mean(-1, keepdim=True)
    g = g - g.mean(-1, keepdim=True)
    s = (torch.sum(e * g, -1, keepdim=True)
         / (torch.sum(g * g, -1, keepdim=True) + 1e-8)) * g
    return 10 * torch.log10(torch.sum(s ** 2, -1)
                            / (torch.sum((e - s) ** 2, -1) + 1e-8) + 1e-8)


def sisdri(est, gt, mixture):
    """Mean SI-SDR improvement over the mixture's first mic, on the samples
    with a target (the campaign's monitor)."""
    pos = torch.amax(torch.abs(gt), dim=(1, 2)) > 0
    imp = _sisdr(est[:, 0], gt[:, 0]) - _sisdr(mixture[:, 0], gt[:, 0])
    return torch.sum(torch.where(pos, imp, torch.zeros_like(imp))) / \
        torch.clamp(torch.sum(pos), min=1)


def host_pool(args, n: int, seed: int, tag: str, sr: int) -> dict:
    """The pool of n scenarios from `seed` (numpy, float32), from the
    `--pool_cache` directory when it holds one: a file of a larger pool of
    the same seed is sliced (scenarios are drawn in order from one
    generator), and a file made with another sr / rir_len / max_order is
    refused."""
    if args.bg_noise > 0:
        tag = "bg" + tag                 # bg pools carry an extra slot
    cache = (Path(args.pool_cache) / f"{tag}_{n}_{seed}.npz"
             if args.pool_cache else None)
    if cache is not None and not cache.exists():
        for cand in sorted(cache.parent.glob(f"{tag}_*_{seed}.npz")):
            try:
                n_cand = int(cand.stem.split("_")[-2])
            except ValueError:
                continue
            if n_cand >= n:
                cache = cand
                break
    want = np.asarray([sr, args.rir_len, args.max_order])
    if cache is not None and cache.exists():
        z = np.load(cache)
        if "_meta" in z.files and not np.array_equal(z["_meta"], want):
            raise SystemExit(
                f"pool cache {cache} was generated with sr/rir_len/max_order="
                f"{z['_meta'].tolist()} but this run wants {want.tolist()}; "
                "delete or regenerate it")
        pool = {k: z[k][:n] for k in z.files if k != "_meta"}
        print(f"loaded cached pool {cache}", flush=True)
        return pool
    if args.require_pool_cache:
        raise SystemExit(
            f"--require_pool_cache: no cache for {tag}_{n}_{seed} under "
            f"{args.pool_cache}; build it first (a run without "
            "--require_pool_cache writes it)")
    pool, _ = campaign.build_pool(
        n, seed=seed, sr=sr, rir_len=args.rir_len,
        order_range=(min(10, args.max_order), args.max_order),
        bg_noise=args.bg_noise > 0)
    if cache is not None:
        cache.parent.mkdir(parents=True, exist_ok=True)
        np.savez(cache, _meta=want, **pool)
    return pool


def _recipe(args) -> dict:
    return {"bf16": args.bf16, "voice": args.voice, "batch": args.batch,
            "clip_seconds": args.clip_seconds,
            "snr_range": [args.snr_min, args.snr_max],
            "bg_noise": args.bg_noise, "lstm_scan": args.lstm_scan}


def main(args: argparse.Namespace):
    """Run the campaign; returns the PLModule."""
    device = resolve_device(args.device)
    no_tf32()
    cfg = read_json(args.config)
    run_dir = Path(args.run_dir)
    (run_dir / "checkpoints").mkdir(parents=True, exist_ok=True)
    with open(run_dir / "config.json", "w") as f:
        json.dump(cfg, f, indent=2)

    # precision is part of the run: a --resume relaunch must not flip a
    # campaign between fp32 and bf16
    args_path = run_dir / "train_stream_args.json"
    if args.resume and args_path.exists():
        recorded = read_json(args_path)
        if recorded.get("bf16") != args.bf16:
            print(f"RESUME: honoring the run's recorded precision "
                  f"bf16={recorded.get('bf16')} (flag said {args.bf16})",
                  flush=True)
            args.bf16 = recorded.get("bf16")
        rec_bg = recorded.get("bg_noise", 0.0)
        if rec_bg != args.bg_noise:
            print(f"RESUME: honoring the run's recorded bg_noise={rec_bg} "
                  f"(flag said {args.bg_noise})", flush=True)
            args.bg_noise = rec_bg
        # the route is part of the run too; a run recorded before the
        # route was trained on the slab kernels
        rec_scan = recorded.get("lstm_scan", "slab")
        if rec_scan != args.lstm_scan:
            raise SystemExit(
                f"{run_dir} trains on --lstm_scan {rec_scan}: resuming it "
                f"with --lstm_scan {args.lstm_scan} is refused")
    else:
        with open(args_path, "w") as f:
            json.dump(_recipe(args), f)

    module = build_module(cfg, device, args.lstm_scan)
    net = module.net
    if args.bf16:
        # the bf16 trunk; the waveform, STFT front-end and loss stay float32
        module.set_bf16_trunk()
    sr = cfg["pl_module_args"]["sr"]
    n_samples = int(args.clip_seconds * sr)
    batch = args.batch or cfg.get("batch_size", 8)
    kw = dict(n_samples=n_samples, sr=sr, snr_range=(args.snr_min,
                                                     args.snr_max),
              voice=args.voice, bg_noise_p=args.bg_noise,
              dense2_p=args.dense2_p)

    print(f"building pool: {args.pool} scenarios (rir_len {args.rir_len}) "
          "...", flush=True)
    t0 = time.time()
    pool = host_pool(args, args.pool, args.seed, "train", sr)
    val_pool = host_pool(args, args.val_pool, args.seed + VAL_SEED, "val",
                         sr)
    idx_probs = None
    if args.radius_weights or args.nin_weights:
        def parse(s):
            return [float(w) for w in s.split(",")] if s else None
        rw, nw = parse(args.radius_weights), parse(args.nin_weights)
        idx_probs = campaign.scenario_probs(pool, radius_weights=rw,
                                            nin_weights=nw)
        print(f"radius_weights {rw} nin_weights {nw}", flush=True)
    print(f"pool built in {time.time() - t0:.1f}s; uploading ...",
          flush=True)

    def upload(p):
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in p.items()}
        if args.pool_bf16:
            out["rirs"] = out["rirs"].bfloat16()   # halves device memory
        return out

    pool, val_pool = upload(pool), upload(val_pool)

    def batch_loss(pool_, idx, gen):
        draws = campaign.batch_draws(gen, pool_, idx, **kw)
        inputs, targets = campaign.make_batch(pool_, idx, draws, **kw)
        model_in = {"mixture": inputs["mixture"]}
        if net.cfg.conditional:
            model_in["dis_embed"] = inputs["dis_embed"]
        return model_in, targets["target"], inputs["mixture"]

    last_path = run_dir / "checkpoints" / "last.pt"
    start_step = 0
    if args.resume and last_path.exists():
        module.load_state(str(last_path))
        start_step = module.epoch * args.val_every
        print(f"resumed from {last_path} at step {start_step}", flush=True)
    scheduler = ReduceLROnPlateau(module.optimizer, mode="min",
                                  patience=args.plateau_patience,
                                  factor=0.5, min_lr=1e-6)

    rng = np.random.default_rng(args.seed + 1)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    log_path = run_dir / "metrics.jsonl"
    best_val = np.inf
    losses = []
    t_start = t_window = time.time()

    @torch.no_grad()
    def run_val():
        module.net.eval()
        vgen = torch.Generator(device=device).manual_seed(VAL_SEED)
        n_val = int(val_pool["active"].shape[0])
        vl, vs = [], []
        for i in range(args.val_batches):
            idx = torch.from_numpy(np.random.default_rng(1000 + i).integers(
                0, n_val, batch)).to(device)
            model_in, gt, mix = batch_loss(val_pool, idx, vgen)
            est = forward(module.net, model_in, args.bf16)
            vl.append(float(module._loss(est, gt)))
            vs.append(float(sisdri(est, gt, mix)))
        return float(np.mean(vl)), float(np.mean(vs))

    for step in range(start_step, args.steps):
        if idx_probs is not None:
            idx = rng.choice(len(idx_probs), batch, p=idx_probs)
        else:
            idx = rng.integers(0, args.pool, batch)
        idx = torch.from_numpy(idx).to(device)
        with torch.no_grad():
            model_in, gt, mix = batch_loss(pool, idx, gen)
        loss, est = train_step(module, model_in, gt, args.bf16)
        losses.append(loss)              # device value; read at log time

        if (step + 1) % args.log_every == 0:
            lval = float(torch.stack(losses).mean())
            losses = []
            sps = args.log_every * batch / (time.time() - t_window)
            t_window = time.time()
            rec = dict(step=step + 1, train_loss=round(lval, 4),
                       train_sisdri=round(float(sisdri(est, gt, mix)), 3),
                       lr=float(module.optimizer.lr),
                       samples_per_sec=round(sps, 2),
                       elapsed_min=round((time.time() - t_start) / 60, 1))
            print(json.dumps(rec), flush=True)
            with open(log_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

        if (step + 1) % args.val_every == 0 or step + 1 == args.steps:
            val_loss, val_sisdri = run_val()
            module.epoch = (step + 1) // args.val_every
            module.metric_values[module.epoch - 1] = {
                "val/loss": {"epoch": val_loss, "num_elements": 1},
                "val/si_sdr_i": {"epoch": val_sisdri, "num_elements": 1},
            }
            module.dump_state(str(last_path))
            tag = ""
            if val_loss < best_val:
                best_val = val_loss
                module.dump_state(str(run_dir / "checkpoints" / "best.pt"))
                tag = " (best)"
            rec = dict(step=step + 1, val_loss=round(val_loss, 4),
                       val_sisdri=round(val_sisdri, 3),
                       lr=float(module.optimizer.lr))
            print(json.dumps(rec) + tag, flush=True)
            with open(log_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
            scheduler.step(val_loss)

    print(f"done: {args.steps} steps in "
          f"{(time.time() - t_start) / 60:.1f} min; best val {best_val:.4f}",
          flush=True)
    return module


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--run_dir", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--pool", type=int, default=3000)
    p.add_argument("--val_pool", type=int, default=180)
    p.add_argument("--val_batches", type=int, default=8)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--clip_seconds", type=float, default=3.0)
    p.add_argument("--rir_len", type=int, default=12000)
    p.add_argument("--max_order", type=int, default=32)
    p.add_argument("--snr_min", type=float, default=-10.0)
    p.add_argument("--snr_max", type=float, default=5.0)
    p.add_argument("--val_every", type=int, default=250)
    p.add_argument("--log_every", type=int, default=25)
    p.add_argument("--plateau_patience", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--pool_bf16", action="store_true",
                   help="store the RIR pool in bf16 (halves device memory)")
    p.add_argument("--voice", default="formant",
                   choices=("formant", "harmonic", "mix"),
                   help="source model: formant voices, harmonic "
                        "quasi-speech, or a 75/25 per-source mix of both")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="mixed-precision train step (bf16 trunk, fp32 "
                        "master params / LSTM carry / loss)")
    p.add_argument("--bg_noise", type=float, default=0.0,
                   help="probability a sample carries far-field background "
                        "noise (needs a bg pool, built when it is > 0)")
    p.add_argument("--radius_weights", default=None,
                   help="comma weights for the 1.0/1.5/2.0 m radius "
                        "classes; default uniform")
    p.add_argument("--nin_weights", default=None,
                   help="comma weights for the 0/1/2 in-bubble-speaker "
                        "classes; default uniform")
    p.add_argument("--dense2_p", type=float, default=0.0,
                   help="probability a 2-in-bubble sample uses the dense-"
                        "overlap curriculum")
    p.add_argument("--pool_cache", default=None,
                   help="directory for cached scenario pools (npz)")
    p.add_argument("--require_pool_cache", action="store_true",
                   help="fail when the pool cache entry is absent instead "
                        "of building it")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--lstm_scan", choices=SCANS, default=scan_from_env(),
                   help="the LSTM scans' kernel route: slab, or seq (the "
                        "custom-VJP route); default from the SB_LSTM_* "
                        "environment, as the JAX trainer")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
