"""Train on sample-dir data: the port of `src/train_pt.py`.

    python -m sound_bubble_tpu_torch.train_pt \
        --config syn_experiments/pretrain_stage.json --run_dir runs/<name> \
        [--seed 0] [--device cuda|cpu] [--bf16] [--lstm_scan slab|seq]

Same arguments and config schema as the JAX trainer (the config's
`sound_bubble_tpu.*` and `torch.optim.*` names resolve to the port through
`utils.ALIASES`), same run-dir layout: a copy of the config as
`config.json`, `checkpoints/last.pt` after every epoch, `checkpoints/best.pt`
when the validation loss is the best so far, resume from `last.pt`, and the
epoch's metrics in `metrics.jsonl`. Per epoch: the train steps, then a
validation epoch with the fixed VAL_SEED, then the scheduler. One process on
one device (`--device`, default `cuda`; no card raises). In float32, with
TF32 off for matrix products and cuDNN convolutions; `--bf16` runs the
model's trunk in bf16 with float32 master params and a float32 STFT
front-end (the JAX trainer's `--bf16`, which records it nowhere but the
log). `--lstm_scan` picks the LSTM scans' kernel route (`ops/rnn.py`): the
slab kernels, or the JAX package's custom-VJP kernel route ("seq"); its
default is "seq" exactly when the JAX package's environment selects that
route (`SB_LSTM_FUSED=0 SB_LSTM_CUSTOM_VJP=1 SB_LSTM_PALLAS_TRAIN=1`). The
route is recorded in the run dir (`train_pt_args.json`), and resuming a run
on the other route is refused. An error ends the run with its traceback.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import time

import torch

from sound_bubble_tpu_torch.data.loader import SeedWorkers, make_loader
from sound_bubble_tpu_torch.ops.rnn import SCANS, scan_from_env
from sound_bubble_tpu_torch.train.logging import init_run
from sound_bubble_tpu_torch.train.loop import test_epoch, train_epoch
from sound_bubble_tpu_torch.utils import (
    import_attr, no_tf32, read_json, resolve_device, seed_all)

VAL_SEED = 0
ARGS_FILE = "train_pt_args.json"


def check_route(args: argparse.Namespace):
    """The LSTM route is part of a run: record it in a new run dir, and
    refuse to resume a run (its `last.pt`) on the other route. A run dir
    from before the route was recorded trained on the slab kernels."""
    path = os.path.join(args.run_dir, ARGS_FILE)
    if os.path.exists(os.path.join(args.run_dir, "checkpoints", "last.pt")):
        recorded = (read_json(path)["lstm_scan"] if os.path.exists(path)
                    else "slab")
        if recorded != args.lstm_scan:
            raise SystemExit(
                f"{args.run_dir} trains on --lstm_scan {recorded}: resuming "
                f"it with --lstm_scan {args.lstm_scan} is refused")
        return
    os.makedirs(args.run_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"lstm_scan": args.lstm_scan}, f)


def train(args: argparse.Namespace):
    """Run the epochs the config asks for; returns the PLModule."""
    device = resolve_device(args.device)
    no_tf32()
    if not args.use_nondeterministic_cudnn:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    seed_all(args.seed)
    params = read_json(args.config)
    check_route(args)

    data_train = import_attr(params["train_dataset"])(
        **params["train_data_args"], split="train")
    data_val = import_attr(params["val_dataset"])(
        **params["val_data_args"], split="val")
    num_workers = min(os.cpu_count() or 1, params["num_workers"])
    train_seeds = SeedWorkers(args.seed)
    shuffle = torch.Generator()
    train_loader = make_loader(data_train, params["batch_size"], num_workers,
                               train_seeds, shuffle)
    test_loader = make_loader(data_val, params["eval_batch_size"],
                              num_workers, SeedWorkers(VAL_SEED))

    hl_module = import_attr(params["pl_module"])(
        **params["pl_module_args"], device=device, lstm_scan=args.lstm_scan)
    if args.bf16:
        hl_module.set_bf16_trunk()
        print("bf16 trunk enabled (fp32 master params / front-end)")

    run_name = os.path.basename(args.run_dir.rstrip("/"))
    checkpoints_dir = os.path.join(args.run_dir, "checkpoints")
    os.makedirs(checkpoints_dir, exist_ok=True)
    if not os.path.exists(os.path.join(args.run_dir, "config.json")):
        shutil.copyfile(args.config, os.path.join(args.run_dir, "config.json"))
    best_path = os.path.join(checkpoints_dir, "best.pt")
    state_path = os.path.join(checkpoints_dir, "last.pt")
    if os.path.exists(state_path):
        hl_module.load_state(state_path)
        print(f"Resumed from {state_path} at epoch {hl_module.epoch}")
    run_log = init_run(params.get("project_name", args.project_name),
                       run_name, args.run_dir)

    for epoch in range(hl_module.epoch, params["epochs"]):
        seed_all(args.seed + epoch)
        train_seeds.epoch = epoch
        shuffle.manual_seed(args.seed + epoch)
        hl_module.on_epoch_start()
        print(f"CURRENT learning rate: {hl_module.get_current_lr():0.08f}")
        print("[TRAINING]")
        t1 = time.time()
        train_loss = train_epoch(hl_module, train_loader)
        print(f"Train epoch time: {time.time() - t1:02f}s")
        print(f"\nTrain set: Average Loss: {train_loss:.4f}\n")

        seed_all(VAL_SEED)
        print("[TESTING]")
        test_loss = test_epoch(hl_module, test_loader)
        print(f"\nTest set: Average Loss: {test_loss:.4f}\n")

        hl_module.on_epoch_end(best_path, run_log)
        hl_module.dump_state(state_path)
        print("\n" + "=" * 25, "FINISHED EPOCH", epoch, "=" * 25 + "\n")
    return hl_module


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True,
                        help="Path to experiment config")
    parser.add_argument("--run_dir", type=str, required=True,
                        help="Path to experiment directory")
    parser.add_argument("--seed", type=int, default=0,
                        help="Random seed for reproducibility")
    parser.add_argument("--use_nondeterministic_cudnn", action="store_true",
                        help="Let cuDNN pick non-deterministic algorithms")
    parser.add_argument("--project_name", type=str, default="AcousticBubble",
                        help="Project name for the run log")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 trunk (fp32 master params); off by "
                             "default")
    parser.add_argument("--lstm_scan", choices=SCANS, default=scan_from_env(),
                        help="the LSTM scans' kernel route: slab, or seq "
                             "(the custom-VJP route); default from the "
                             "SB_LSTM_* environment, as the JAX trainer")
    return parser.parse_args(argv)


if __name__ == "__main__":
    train(parse_args())
