"""JAX reference numbers for the first train step of a config.

One `PLModule` step of the JAX package at full width, fp32 on the CPU, on
the seeded batch of `sound_bubble_tpu_torch.data.synth.golden_batch(0)` (4
clips of 2.5 s at 24 kHz, one with an empty bubble). Writes the loss, the
global gradient norm before the clip and every parameter's gradient norm
(keyed by the port's `state_dict` names), the numbers `chip_smoke.py` holds
the port's kernel path against:

- the flagship: `syn_experiments/pretrain_stage.json` (F=145, D=32, B=6,
  H=64, SNRLP) from `runs/finetune_r5/checkpoints/best.pt`, to
  `runs/train_step_golden_jax.json`:

    JAX_PLATFORMS=cpu python tools/jax_train_step_golden.py

- the edge model: `real_experiments/orangpi_model_finetune.json` (conv_lstm,
  unconditioned, D=24, B=3, MultiResoFuseLoss) from the seeded
  `runs/edge_orangpi_seeded/checkpoints/best.pt`
  (`tools/jax_goldens_edge.py`), to `runs/train_step_golden_edge_jax.json`:

    JAX_PLATFORMS=cpu python tools/jax_train_step_golden.py --edge
"""
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from sound_bubble_tpu.train.module import PLModule  # noqa: E402
from sound_bubble_tpu_torch.data.synth import golden_batch  # noqa: E402

# (config, checkpoint the step starts from, output)
CASES = {
    "flagship": ("syn_experiments/pretrain_stage.json",
                 "runs/finetune_r5/checkpoints/best.pt",
                 "runs/train_step_golden_jax.json"),
    "edge": ("real_experiments/orangpi_model_finetune.json",
             "runs/edge_orangpi_seeded/checkpoints/best.pt",
             "runs/train_step_golden_edge_jax.json"),
}
SEED = 0


def main():
    jax.config.update("jax_platforms", "cpu")
    config, ckpt, out = CASES["edge" if "--edge" in sys.argv[1:]
                              else "flagship"]
    with open(os.path.join(REPO, config)) as f:
        args = json.load(f)["pl_module_args"]
    args["init_ckpt"] = os.path.join(REPO, ckpt)
    np.random.seed(SEED)
    module = PLModule(**args, use_dp=False)
    inputs, targets = golden_batch(SEED)

    def loss_fn(params):
        out = module.net.apply({"params": params},
                               {k: jnp.asarray(inputs[k])
                                for k in ("mixture", "dis_embed")})
        # PLModule's loss: the mean of the per-sample losses (every mask
        # weight 1: no padding on one device)
        return jnp.mean(jnp.atleast_1d(module.loss_fn(
            est=out["output"], gt=jnp.asarray(targets["target"]))))

    t0 = time.perf_counter()
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(module.params)
    leaves = {".".join(str(getattr(k, "key", k)) for k in path):
              float(jnp.sqrt(jnp.sum(jnp.square(g))))
              for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
    result = {
        "_comment": (
            "JAX package, PLModule loss and gradients, fp32 on the CPU, "
            f"{os.path.basename(config)} at full width from {ckpt}, batch "
            f"golden_batch({SEED}) (tools/jax_train_step_golden.py)"),
        "config": config, "init_ckpt": ckpt,
        "batch": f"sound_bubble_tpu_torch.data.synth.golden_batch({SEED})",
        "loss": float(loss),
        "grad_norm": float(np.sqrt(sum(v ** 2 for v in leaves.values()))),
        "grad_norms": leaves,
    }
    with open(os.path.join(REPO, out), "w") as f:
        json.dump(result, f, indent=1)
    print(f"loss {result['loss']:.6f}, grad norm {result['grad_norm']:.6f}, "
          f"{len(leaves)} leaves, {time.perf_counter() - t0:.1f} s -> {out}")


if __name__ == "__main__":
    main()
