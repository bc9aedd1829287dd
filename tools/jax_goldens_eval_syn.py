"""JAX reference numbers of the eval CLIs on the in-repo golden samples.

Runs the JAX package's own CLIs, offline, fp32 on the CPU, over
`test_samples/syn_{1m,1_5m,2m}`:

- `src/eval_syn.py` on the flagship (`runs/finetune_r5`), each directory at
  its radius (`--distance_threshold 1 / 1.5 / 2`): every column of its
  `results.csv` per sample (SNR, SI-SNR, SI-SDR and their improvements,
  STOI, PESQ; decay for an empty bubble);
- `src/eval.py --distance_threshold -1 --gt_threshold <radius>` on the
  seeded Orange Pi model (`runs/edge_orangpi_seeded`, unconditioned).

and writes them to `runs/goldens_eval_syn_jax.json` (per-sample rows, keyed
`<radius>/<sample>`, and per-radius means), the numbers `chip_smoke.py`
holds the port's `eval_syn` / `eval` CLIs against. Beside them it records
how far STOI and PESQ move with the model's output, on each target sample
(`sensitivity`): the port's offline output on the CPU (its intra BLSTMs on
the fused inference route's plain version) against JAX's, relative to the
output's peak, the metrics' change between the two, and their largest
change over three draws of white noise added to JAX's output with a
max-abs of about 1e-4 of its peak (std 2.5e-5 of the peak), the port's
whole-model bar. `chip_smoke.py` derives its STOI / PESQ bars from these.
About 5 minutes:

    JAX_PLATFORMS=cpu python tools/jax_goldens_eval_syn.py
"""
import argparse
import csv
import json
import os
import sys
import tempfile
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "src"))

import eval as jax_eval  # noqa: E402
import eval_syn as jax_eval_syn  # noqa: E402
from sound_bubble_tpu import utils as jutils  # noqa: E402
from sound_bubble_tpu.train.checkpoint import load_checkpoint  # noqa: E402

RUN_DIR = "runs/finetune_r5"
EDGE_RUN_DIR = "runs/edge_orangpi_seeded"
OUT = os.path.join(REPO, "runs", "goldens_eval_syn_jax.json")
RADII = (("1m", 1.0), ("1_5m", 1.5), ("2m", 2.0))
NOISE_STD = 2.5e-5          # of the output's peak: max-abs ~1e-4 of it


def read_rows(path):
    """results.csv -> {sample: {column: float or int}}, empty cells left
    out."""
    rows = {}
    with open(path, newline="") as f:
        for rec in csv.DictReader(f):
            name = rec.pop("sample")
            rec.pop("")
            rows[name] = {k: (int(v) if k == "n_tgt_speakers" else float(v))
                          for k, v in rec.items() if v != ""}
    return rows


def parse(cli, argv):
    """argv parsed with the CLI's flags (its parser is built in its
    `__main__` block)."""
    p = argparse.ArgumentParser()
    for name in ("test_dir", "run_dir", "output_dir"):
        p.add_argument(name)
    p.add_argument("--distance_threshold", type=float, default=1.0)
    p.add_argument("--sr", type=int, default=24000)
    p.add_argument("--use_cuda", action="store_true")
    if cli is jax_eval_syn:
        p.add_argument("--save_id", type=int, default=-1)
    else:
        p.add_argument("--gt_threshold", type=float, default=1.5)
    return p.parse_args(argv)


def run(cli, test_dir, run_dir, flags):
    """The CLI over test_dir into a temporary output dir; its rows."""
    with tempfile.TemporaryDirectory() as out:
        cli.main(parse(cli, [test_dir, run_dir, out, *flags]))
        return read_rows(os.path.join(out, "results.csv"))


def weights_only(run_dir):
    """The run's PLModule with best.pt's weights. The seeded edge
    checkpoint holds weights only, and the JAX package's
    `load_torch_pretrained` also restores an optimizer state."""
    module = jutils.load_net(os.path.join(run_dir, "config.json"))
    weights = load_checkpoint(os.path.join(run_dir, "checkpoints",
                                           "best.pt"))["model"]
    module.params = jax.device_put(
        jax.tree_util.tree_map(jnp.asarray, weights), module._rep)
    return module


def sensitivity(result):
    """Per target sample: the port's CPU output vs JAX's, and how far STOI
    and PESQ move with it and with NOISE_STD white noise."""
    import torch

    from sound_bubble_tpu.evaluation import load_testcase, run_testcase
    from sound_bubble_tpu.metrics.metrics import Metrics
    from sound_bubble_tpu_torch import evaluation as tev
    from sound_bubble_tpu_torch import utils as tutils

    torch.set_num_threads(4)
    jax_model = jutils.load_torch_pretrained(os.path.join(REPO,
                                                          RUN_DIR)).model
    port_model = tutils.load_torch_pretrained(
        os.path.join(REPO, RUN_DIR), device="cpu", pallas_blstm=True).model
    metrics = {"stoi": Metrics("STOI"), "pesq": Metrics("PESQ")}
    out = {}
    for radius, threshold in RADII:
        rdir = os.path.join(REPO, "test_samples", f"syn_{radius}")
        for name in sorted(os.listdir(rdir)):
            _, mixture, gt, tgt, _ = load_testcase(
                os.path.join(rdir, name), 24000, threshold)
            if not tgt:
                continue
            want = run_testcase(jax_model, mixture, None, threshold)
            got = tev.run_testcase_offline(port_model, mixture, threshold)
            peak = float(np.abs(want).max())
            row = {"output_rel": float(np.abs(got - want).max() / peak)}
            for key, metric in metrics.items():
                def score(est):
                    return float(metric(est=est, gt=gt, mix=mixture[0:1]))
                base = score(want)
                row[f"{key}_port_cpu"] = abs(score(got) - base)
                row[f"{key}_noise"] = max(
                    abs(score(want + np.random.default_rng(seed)
                              .standard_normal(want.shape)
                              .astype(np.float32) * (NOISE_STD * peak))
                        - base) for seed in range(3))
            out[f"{radius}/{name}"] = row
            print(radius, name, row, flush=True)
    result["sensitivity"] = out


def main():
    jax.config.update("jax_platforms", "cpu")
    result = {"_comment": (
        "JAX package's src/eval_syn.py (flagship) and src/eval.py "
        "--distance_threshold -1 (seeded Orange Pi), offline Net, fp32 on "
        "the CPU, over test_samples/ (tools/jax_goldens_eval_syn.py)"),
        "run_dir": RUN_DIR, "edge_run_dir": EDGE_RUN_DIR,
        "samples": {}, "edge_samples": {}, "means": {}}
    for radius, threshold in RADII:
        test_dir = os.path.join(REPO, "test_samples", f"syn_{radius}")
        rows = run(jax_eval_syn, test_dir, os.path.join(REPO, RUN_DIR),
                   ["--distance_threshold", str(threshold)])
        for name, row in rows.items():
            result["samples"][f"{radius}/{name}"] = row
        result["means"][radius] = {
            k: float(np.mean([r[k] for r in rows.values() if k in r]))
            for k in ("sisdri", "decay", "stoi", "pesq", "stoi_in",
                      "pesq_in") if any(k in r for r in rows.values())}
        with mock.patch.object(jutils, "load_torch_pretrained",
                               weights_only):
            edge = run(jax_eval, test_dir, os.path.join(REPO, EDGE_RUN_DIR),
                       ["--distance_threshold", "-1", "--gt_threshold",
                        str(threshold)])
        for name, row in edge.items():
            result["edge_samples"][f"{radius}/{name}"] = row
        print(radius, result["means"][radius], flush=True)
    sensitivity(result)
    with open(OUT, "w") as f:
        json.dump(result, f, indent=2)
        f.write("\n")


if __name__ == "__main__":
    main()
