"""The port's trainer CLI and data pipeline on the CPU, at a small width.

- the port's `DistanceEmbedDataset` gives the JAX package's items on the
  same sample dirs (both host numpy code: exactly);
- the spawn-started loader workers are seeded as `src/train_pt.py` seeds
  them, and shuffling follows its `torch.Generator`;
- `python -m sound_bubble_tpu_torch.train_pt --device cpu` on the reference
  pretrain config (widths cut to B=2, D=8, H=8; 2 epochs of 3 steps) writes
  `config.json`, `last.pt`, `best.pt` and `metrics.jsonl`, and a second run
  with `epochs=3` resumes from `last.pt` at epoch 2.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sound_bubble_tpu.data.dataset import DistanceEmbedDataset as JDataset
from sound_bubble_tpu_torch.data.dataset import DistanceEmbedDataset
from sound_bubble_tpu_torch.data.loader import SeedWorkers, make_loader
from sound_bubble_tpu_torch.data.synth import write_sample_dirs
from sound_bubble_tpu_torch.train.checkpoint import load_checkpoint
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "syn_experiments", "pretrain_stage.json")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    return write_sample_dirs(str(root), seed=0, n_train=4, n_val=2)


def _args(dirs):
    with open(CONFIG) as f:
        cfg = json.load(f)
    args = dict(cfg["train_data_args"])
    args["dataset_dirs"] = [{"path": p, "max_samples": 10} for p in dirs]
    return args


def test_dataset_matches_jax(data):
    args = _args(data["train"])
    got, want = DistanceEmbedDataset(**args, split="train"), JDataset(
        **args, split="train")
    assert len(got) == len(want) == 12
    n_neg = 0
    for i in range(len(got)):
        gi, gt = got[i]
        wi, wt = want[i]
        for k in wi:
            np.testing.assert_array_equal(gi[k], wi[k])
        for k in wt:
            np.testing.assert_array_equal(gt[k], wt[k])
        n_neg += gt["num_target_speakers"] == 0
        assert gi["mixture"].shape == (6, 60000)
    assert n_neg == 3


def test_loader_workers_and_shuffle(data):
    ds = DistanceEmbedDataset(**_args(data["train"]), split="train")
    gen = torch.Generator()
    orders = []
    for _ in range(2):
        gen.manual_seed(7)
        loader = make_loader(ds, 4, 1, SeedWorkers(7), gen)
        batches = list(loader)
        assert len(batches) == 3
        assert batches[0][0]["mixture"].shape == (4, 6, 60000)
        orders.append(np.concatenate([b[0]["dis_embed"] for b in batches]))
    np.testing.assert_array_equal(orders[0], orders[1])


def _run(cfg_path, run_dir):
    # two intra-op threads: the CLI shares the machine with the other test
    # workers, and a thread per core each oversubscribes it many times over
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "sound_bubble_tpu_torch.train_pt", "--config",
         cfg_path, "--run_dir", run_dir, "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)


def test_train_pt_runs_and_resumes(data, tmp_path):
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg["pl_module_args"]["model_params"].update(D=8, H=8, B=2)
    cfg["train_data_args"] = _args(data["train"])
    cfg["val_data_args"]["dataset_dirs"] = [
        {"path": p, "max_samples": 10} for p in data["val"]]
    cfg["epochs"], cfg["num_workers"] = 2, 0
    cfg_path, run_dir = str(tmp_path / "cfg.json"), str(tmp_path / "run")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)

    proc = _run(cfg_path, run_dir)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("  train step ") == 6
    for name in ("config.json", "metrics.jsonl", "checkpoints/last.pt",
                 "checkpoints/best.pt"):
        assert os.path.exists(os.path.join(run_dir, name)), name
    last = load_checkpoint(os.path.join(run_dir, "checkpoints", "last.pt"))
    assert last["current_epoch"] == 2
    assert np.isfinite(last["metric_values"][1]["train/loss"]["epoch"])

    cfg["epochs"] = 3
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    proc = _run(cfg_path, run_dir)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Resumed from" in proc.stdout and "at epoch 2" in proc.stdout
    assert proc.stdout.count("  train step ") == 3
    last = load_checkpoint(os.path.join(run_dir, "checkpoints", "last.pt"))
    assert last["current_epoch"] == 3
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        assert len(f.readlines()) == 3
