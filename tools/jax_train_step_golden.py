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

- the attention flagship: `runs/attn_flagship_seeded/config.json`
  (`syn_experiments/finetune_stage.json` with `use_attn: true`: L=4, E=2,
  local_atten_len 100, MultiResoFuseLoss) from its seeded
  `checkpoints/best.pt` (`tools/jax_goldens_attn.py`), to
  `runs/train_step_golden_attn_jax.json`:

    JAX_PLATFORMS=cpu python tools/jax_train_step_golden.py --attn

  This golden's numbers are the same step in float64 (`jax_enable_x64`,
  the params and the batch widened, every float32 cast the package makes
  kept at float64); the fp32 step is recorded beside them under `"fp32"`.
  The attention's PReLU slopes sum ~1.5M products that largely cancel, so
  their grads move far more than a rounding of the values they sum: the
  fp32 step of the JAX package on the CPU is 1.5e-3 from the float64 step
  in one of them (`block1.attn_k.act.alpha`), more than the 1e-3 a leaf that the port's fp32 step
  is held to, so the fp32 numbers cannot be the reference there. The STFT
  filterbank keeps its float32 values, so that the float64 step computes
  the same function as the fp32 one.

- the flagship's bf16 step as the campaign trainer takes it
  (`src/train_stream.py --bf16`: the params through `utils.cast_bf16`, the
  net built with `compute_dtype="bf16"`, the output cast to fp32 for the
  loss), the flagship config and checkpoint, to
  `runs/train_step_golden_bf16_jax.json`:

    JAX_PLATFORMS=cpu python tools/jax_train_step_golden.py --bf16
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

import sound_bubble_tpu.ops.stft as jstft  # noqa: E402
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
    "attn": ("runs/attn_flagship_seeded/config.json",
             "runs/attn_flagship_seeded/checkpoints/best.pt",
             "runs/train_step_golden_attn_jax.json"),
    "bf16": ("syn_experiments/pretrain_stage.json",
             "runs/finetune_r5/checkpoints/best.pt",
             "runs/train_step_golden_bf16_jax.json"),
}
SEED = 0


def main():
    jax.config.update("jax_platforms", "cpu")
    case = next((c for c in ("edge", "attn", "bf16")
                 if f"--{c}" in sys.argv[1:]),
                "flagship")
    config, ckpt, out = CASES[case]
    with open(os.path.join(REPO, config)) as f:
        args = json.load(f)["pl_module_args"]
    args["init_ckpt"] = os.path.join(REPO, ckpt)
    np.random.seed(SEED)
    module = PLModule(**args, use_dp=False)
    inputs, targets = golden_batch(SEED)
    t0 = time.perf_counter()
    result = {
        "_comment": (
            "JAX package, PLModule loss and gradients, "
            + ("bf16 trunk through cast_bf16 (fp32 master params)"
               if case == "bf16" else "fp32") + " on the CPU, "
            f"{os.path.basename(config)} at full width from {ckpt}, batch "
            f"golden_batch({SEED}) (tools/jax_train_step_golden.py)"),
        "config": config, "init_ckpt": ckpt,
        "batch": f"sound_bubble_tpu_torch.data.synth.golden_batch({SEED})",
        **one_step(case, module, inputs, targets)}
    if case == "attn":
        fp32 = {k: result.pop(k) for k in ("loss", "grad_norm",
                                           "grad_norms")}
        jax.config.update("jax_enable_x64", True)
        jnp.float32 = jnp.float64      # the package's casts to float32
        # the same function: the STFT filterbank keeps its float32 values
        # (the model's constants; the slopes' grads amplify any change)
        fb64 = jstft.stft_filterbank
        jstft.stft_filterbank = lambda *a, **k: np.asarray(fb64(*a, **k),
                                                           np.float32)
        module.params = jax.tree_util.tree_map(
            lambda p: jnp.asarray(np.asarray(p), jnp.float64), module.params)
        result.update(one_step(case, module, inputs, targets, np.float64))
        result["_comment"] = result["_comment"].replace(
            "fp32 on the CPU", "float64 on the CPU (fp32 under \"fp32\")")
        result["precision"] = "float64"
        result["fp32"] = fp32
    with open(os.path.join(REPO, out), "w") as f:
        json.dump(result, f, indent=1)
    print(f"loss {result['loss']:.9f}, grad norm {result['grad_norm']:.9f}, "
          f"{len(result['grad_norms'])} leaves, "
          f"{time.perf_counter() - t0:.1f} s -> {out}")


def one_step(case, module, inputs, targets, dtype=np.float32):
    """The loss, the pre-clip global grad norm and the per-leaf grad norms
    of one step on (inputs, targets) in `dtype`."""
    inputs = {k: np.asarray(v, dtype) for k, v in inputs.items()}
    targets = {k: np.asarray(v, dtype) for k, v in targets.items()}
    net, cast = module.net, (lambda p: p)
    if case == "bf16":
        import dataclasses

        import sound_bubble_tpu.ops.rnn as rnn
        import sound_bubble_tpu.utils as utils
        from sound_bubble_tpu.models.tfgridnet.model import Net
        net = Net(dataclasses.replace(net.cfg, compute_dtype="bf16"))
        cast = utils.cast_bf16
        # the route the JAX package takes for a bf16 trunk on one TPU: every
        # LSTM scan through the Pallas slab kernels (here in interpret mode)
        rnn.set_slab(True)

    def loss_fn(params):
        out = net.apply({"params": cast(params)},
                        {k: jnp.asarray(inputs[k])
                         for k in ("mixture", "dis_embed")})
        # PLModule's loss: the mean of the per-sample losses (every mask
        # weight 1: no padding on one device)
        return jnp.mean(jnp.atleast_1d(module.loss_fn(
            est=out["output"].astype(jnp.float32),
            gt=jnp.asarray(targets["target"]))))

    step = jax.jit(jax.value_and_grad(loss_fn))
    if case == "bf16":
        # XLA on the CPU may keep an fp32 value where the code casts to bf16
        # (excess precision); this golden rounds at every cast, as the
        # Pallas kernels do on the TPU, and as the port does
        step = step.lower(module.params).compile(
            compiler_options={"xla_allow_excess_precision": False})
    loss, grads = step(module.params)
    leaves = {".".join(str(getattr(k, "key", k)) for k in path):
              float(jnp.sqrt(jnp.sum(jnp.square(g))))
              for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
    return {"loss": float(loss),
            "grad_norm": float(np.sqrt(sum(v ** 2
                                           for v in leaves.values()))),
            "grad_norms": leaves}


if __name__ == "__main__":
    main()
