"""Seeded edge weights and the JAX package's serving numbers for them.

There is no trained edge checkpoint in the repo. This script builds the JAX
Orange Pi model (`real_experiments/orangpi_model_finetune.json`: conv_lstm,
unconditioned, F=145, D=24, B=3, H=64, lstm_down=5), initialised from
`jax.random.PRNGKey(0)`, and writes

- `runs/edge_orangpi_seeded/`: `config.json` (the finetune config) and
  `checkpoints/best.pt` (a pickle of {"model": the parameter tree of numpy
  arrays}, which the port's `train/checkpoint.py:load_checkpoint` reads);
- `runs/goldens_edge_jax.json`: the 9 clips of `test_samples/` streamed
  chunk by chunk through the JAX `ModelWrapper` (the XLA path), fp32 on the
  CPU, padded and trimmed as `sound_bubble_tpu_torch.evaluation.run_testcase`
  pads them: SI-SDRi or decay per sample, and the first 20 chunks of the
  streamed output of `syn_1m/00002`.

`chip_smoke.py` and `tests/test_torch_port_edge.py` hold the port against
these. Regenerate both with (about a minute on the CPU):

    JAX_PLATFORMS=cpu python tools/jax_goldens_edge.py
"""
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from sound_bubble_tpu import utils  # noqa: E402
from sound_bubble_tpu.evaluation import load_testcase  # noqa: E402
from sound_bubble_tpu.metrics.metrics import Metrics, compute_decay  # noqa: E402
from sound_bubble_tpu.ops.stft import mod_pad  # noqa: E402
from sound_bubble_tpu.runtime.streaming import (  # noqa: E402
    ModelWrapper, streaming_inference)
from sound_bubble_tpu.train.checkpoint import save_checkpoint  # noqa: E402

CONFIG = "real_experiments/orangpi_model_finetune.json"
RUN_DIR = "runs/edge_orangpi_seeded"
OUT = os.path.join(REPO, "runs", "goldens_edge_jax.json")
RADII = (("1m", 1.0), ("1_5m", 1.5), ("2m", 2.0))
HEAD_SAMPLE, HEAD_CHUNKS = "syn_1m/00002", 20
SEED = 0


def stream(wrapper, cfg, mixture):
    """[M, N] -> [num_src, N], as the port's `run_testcase` streams it."""
    x, mod = mod_pad(jnp.asarray(mixture, jnp.float32)[None],
                     cfg.stft_chunk_size, (cfg.stft_back_pad,
                                           cfg.stft_pad_size))
    wrapper.reset()
    y = np.asarray(streaming_inference(wrapper, x, cfg.stft_chunk_size,
                                       cfg.stft_pad_size))[0]
    return y[..., :-mod] if mod else y


def main():
    jax.config.update("jax_platforms", "cpu")
    with open(os.path.join(REPO, CONFIG)) as f:
        args = json.load(f)["pl_module_args"]
    net = utils.import_attr(args["model"])(**args["model_params"])
    cfg = net.cfg
    dummy = {"mixture": jnp.zeros((1, cfg.num_ch, cfg.n_fft), jnp.float32)}
    params = net.init(jax.random.PRNGKey(SEED), dummy)["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    n_params = sum(v.size for v in jax.tree_util.tree_leaves(tree))

    run_dir = os.path.join(REPO, RUN_DIR)
    os.makedirs(os.path.join(run_dir, "checkpoints"), exist_ok=True)
    shutil.copyfile(os.path.join(REPO, CONFIG),
                    os.path.join(run_dir, "config.json"))
    save_checkpoint(os.path.join(run_dir, "checkpoints", "best.pt"),
                    {"model": tree})

    wrapper = ModelWrapper(net, params)
    si_sdr_i = Metrics("si_sdr_i")
    result = {"_comment": (
        "JAX package, ModelWrapper streamed chunk by chunk, fp32 on the CPU, "
        f"{RUN_DIR} (seeded, untrained: {CONFIG} from PRNGKey({SEED})) over "
        "test_samples/ (tools/jax_goldens_edge.py)"),
        "run_dir": RUN_DIR, "config": CONFIG, "n_params": int(n_params),
        "samples": {}, "sisdri": {}, "decay": {}}
    for radius, threshold in RADII:
        sisdris, decays = [], []
        rdir = os.path.join(REPO, "test_samples", f"syn_{radius}")
        for name in sorted(os.listdir(rdir)):
            _, mixture, gt, tgt, _ = load_testcase(
                os.path.join(rdir, name), 24000, threshold)
            out = stream(wrapper, cfg, mixture)
            key = f"{radius}/{name}"
            if tgt:
                v = float(si_sdr_i(est=out, gt=gt, mix=mixture[0:1]))
                sisdris.append(v)
                result["samples"][key] = {"sisdri": v}
            else:
                v = float(compute_decay(est=out, mix=mixture[0:1]))
                decays.append(v)
                result["samples"][key] = {"decay": v}
            if f"syn_{key}" == HEAD_SAMPLE:
                head = out[0, :HEAD_CHUNKS * cfg.stft_chunk_size]
            print(key, result["samples"][key], flush=True)
        result["sisdri"][radius] = float(np.mean(sisdris))
        result["decay"][radius] = float(np.mean(decays))
    result["head"] = {"sample": HEAD_SAMPLE, "chunks": HEAD_CHUNKS,
                      "output": [float(v) for v in head]}
    with open(OUT, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(f"{n_params} parameters -> {RUN_DIR}; "
          + json.dumps({k: result[k] for k in ("sisdri", "decay")}))


if __name__ == "__main__":
    main()
