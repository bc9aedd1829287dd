"""Seeded attention weights and the JAX package's serving numbers for them.

No configuration in the repo turns local attention on, and there are no
trained attention weights. This script builds two JAX models with
`use_attn: true`, each from a configuration of the repo with only that
switch changed, initialised from `jax.random.PRNGKey(0)`:

- the flagship (`syn_experiments/finetune_stage.json`: F=145, D=32, B=6,
  H=64, L=4, E=2, local_atten_len 100, conv3 FiLM) to
  `runs/attn_flagship_seeded/`;
- the Orange Pi edge model (`real_experiments/orangpi_model_finetune.json`:
  D=24, B=3, conv_lstm s=5, unconditioned, the same attention widths) to
  `runs/attn_orangpi_seeded/`;

each as `config.json` and `checkpoints/best.pt` (a pickle of {"model": the
parameter tree of numpy arrays}, which the port's
`train/checkpoint.py:load_checkpoint` reads). Then it writes
`runs/goldens_attn_jax.json`: for each net, the 9 clips of `test_samples/`
streamed chunk by chunk through the JAX `ModelWrapper` (the XLA path, fp32
on the CPU; the conditioned net with the one-hot of each clip's radius),
padded and trimmed as `sound_bubble_tpu_torch.evaluation.run_testcase` pads
them: SI-SDRi or decay per sample, and the first 20 chunks of the streamed
output of `syn_1m/00002`.

`chip_smoke.py` (phase 17) and `tests/test_torch_port_attn.py` hold the
port against these. The JAX golden of the flagship's first train step is
`tools/jax_train_step_golden.py --attn`. Regenerate both with (a few
minutes on the CPU):

    JAX_PLATFORMS=cpu python tools/jax_goldens_attn.py
    JAX_PLATFORMS=cpu python tools/jax_train_step_golden.py --attn
"""
import json
import os
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

# net -> (source configuration, run dir written)
NETS = {"flagship": ("syn_experiments/finetune_stage.json",
                     "runs/attn_flagship_seeded"),
        "orangpi": ("real_experiments/orangpi_model_finetune.json",
                    "runs/attn_orangpi_seeded")}
OUT = os.path.join(REPO, "runs", "goldens_attn_jax.json")
RADII = (("1m", 1.0), ("1_5m", 1.5), ("2m", 2.0))
# the distance embedding of each radius (the port's `evaluation.ONE_HOT`)
ONE_HOT = {1.0: [[0.0, 0.0, 1.0]], 1.5: [[0.0, 1.0, 0.0]],
           2.0: [[1.0, 0.0, 0.0]]}
HEAD_SAMPLE, HEAD_CHUNKS = "syn_1m/00002", 20
SEED = 0


def stream(wrapper, cfg, mixture, dis_embed):
    """[M, N] -> [num_src, N], as the port's `run_testcase` streams it."""
    x, mod = mod_pad(jnp.asarray(mixture, jnp.float32)[None],
                     cfg.stft_chunk_size, (cfg.stft_back_pad,
                                           cfg.stft_pad_size))
    wrapper.reset()
    y = np.asarray(streaming_inference(
        wrapper, x, cfg.stft_chunk_size, cfg.stft_pad_size,
        dis_embed))[0]
    return y[..., :-mod] if mod else y


def seeded(config, run_dir):
    """The attention net of `config`, its seeded params written to
    `run_dir`. Returns (net, params, n_params)."""
    with open(os.path.join(REPO, config)) as f:
        full = json.load(f)
    full["pl_module_args"]["model_params"]["use_attn"] = True
    args = full["pl_module_args"]
    net = utils.import_attr(args["model"])(**args["model_params"])
    cfg = net.cfg
    dummy = {"mixture": jnp.zeros((1, cfg.num_ch, cfg.n_fft), jnp.float32),
             "dis_embed": jnp.zeros((1, 3), jnp.float32)}
    params = net.init(jax.random.PRNGKey(SEED), dummy)["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    os.makedirs(os.path.join(REPO, run_dir, "checkpoints"), exist_ok=True)
    with open(os.path.join(REPO, run_dir, "config.json"), "w") as f:
        json.dump(full, f, indent=2)
        f.write("\n")
    save_checkpoint(os.path.join(REPO, run_dir, "checkpoints", "best.pt"),
                    {"model": tree})
    return net, params, sum(v.size for v in jax.tree_util.tree_leaves(tree))


def goldens(net, params):
    cfg = net.cfg
    wrapper = ModelWrapper(net, params)
    si_sdr_i = Metrics("si_sdr_i")
    out_json = {"samples": {}, "sisdri": {}, "decay": {}}
    for radius, threshold in RADII:
        sisdris, decays = [], []
        rdir = os.path.join(REPO, "test_samples", f"syn_{radius}")
        dis = (jnp.asarray(ONE_HOT[threshold], jnp.float32)
               if cfg.conditional else None)
        for name in sorted(os.listdir(rdir)):
            _, mixture, gt, tgt, _ = load_testcase(
                os.path.join(rdir, name), 24000, threshold)
            out = stream(wrapper, cfg, mixture, dis)
            key = f"{radius}/{name}"
            if tgt:
                v = float(si_sdr_i(est=out, gt=gt, mix=mixture[0:1]))
                sisdris.append(v)
                out_json["samples"][key] = {"sisdri": v}
            else:
                v = float(compute_decay(est=out, mix=mixture[0:1]))
                decays.append(v)
                out_json["samples"][key] = {"decay": v}
            if f"syn_{key}" == HEAD_SAMPLE:
                head = out[0, :HEAD_CHUNKS * cfg.stft_chunk_size]
            print(key, out_json["samples"][key], flush=True)
        out_json["sisdri"][radius] = float(np.mean(sisdris))
        out_json["decay"][radius] = float(np.mean(decays))
    out_json["head"] = {"sample": HEAD_SAMPLE, "chunks": HEAD_CHUNKS,
                        "output": [float(v) for v in head]}
    return out_json


def main():
    jax.config.update("jax_platforms", "cpu")
    result = {"_comment": (
        "JAX package, ModelWrapper streamed chunk by chunk, fp32 on the CPU, "
        "seeded untrained attention nets (use_attn: true, PRNGKey("
        f"{SEED})) over test_samples/ (tools/jax_goldens_attn.py)")}
    for name, (config, run_dir) in NETS.items():
        net, params, n_params = seeded(config, run_dir)
        result[name] = {"run_dir": run_dir, "config": config,
                        "n_params": int(n_params), **goldens(net, params)}
        print(f"{name}: {n_params} parameters -> {run_dir}; " + json.dumps(
            {k: result[name][k] for k in ("sisdri", "decay")}), flush=True)
    with open(OUT, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
