"""JAX reference numbers for the flagship's first bf16 train step on the
custom-VJP kernel route.

The step of `tools/jax_train_step_golden.py --bf16` (the campaign trainer's
bf16 step: the params through `utils.cast_bf16`, `compute_dtype="bf16"`,
`syn_experiments/pretrain_stage.json` from
`runs/finetune_r5/checkpoints/best.pt` on `golden_batch(0)`), but with
every LSTM scan on the route that `SB_LSTM_FUSED=0 SB_LSTM_CUSTOM_VJP=1
SB_LSTM_PALLAS_TRAIN=1` selects: `ops/rnn.py:set_fused_scan(False)` and
`set_pallas_train(True)`, the inter LSTM through `lstm_pallas_train` and
the intra BLSTM through `blstm_pallas_train` (the Pallas kernels of
`ops/pallas/lstm_train_kernel.py`, here in interpret mode, compiled with
every bf16 rounding kept). That route rounds otherwise than the slab
route of `runs/train_step_golden_bf16_jax.json` (x@W_ih is rounded to
bf16 before the bias is added, and the bf16 sigmoid is XLA's expansion),
so its bf16 step is another function: this is the golden the port's
`--lstm_scan seq` bf16 step is held to. Writes
`runs/train_step_golden_bf16_seq_jax.json`:

    JAX_PLATFORMS=cpu python tools/jax_train_step_golden_seq.py

The calls of the kernels' wrappers are counted while the step is traced,
and the run fails unless every block's scans went through them.
"""
import json
import os
import sys
import time

import jax
import numpy as np

TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TOOLS)

import jax_train_step_golden as base  # noqa: E402
import sound_bubble_tpu.ops.rnn as rnn  # noqa: E402
from sound_bubble_tpu.ops.pallas import lstm_train_kernel as jk  # noqa: E402
from sound_bubble_tpu.train.module import PLModule  # noqa: E402

OUT = "runs/train_step_golden_bf16_seq_jax.json"


def main():
    jax.config.update("jax_platforms", "cpu")
    config, ckpt, _ = base.CASES["bf16"]
    with open(os.path.join(base.REPO, config)) as f:
        args = json.load(f)["pl_module_args"]
    args["init_ckpt"] = os.path.join(base.REPO, ckpt)
    np.random.seed(base.SEED)
    module = PLModule(**args, use_dp=False)
    inputs, targets = base.golden_batch(base.SEED)

    calls = {"lstm_seq_fwd": 0, "lstm_seq_bwd": 0, "_blstm_fwd": 0}
    for name in calls:
        orig = getattr(jk, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        setattr(jk, name, counted)
    rnn.set_fused_scan(False)
    rnn.set_pallas_train(True)
    t0 = time.perf_counter()
    result = {
        "_comment": (
            "JAX package, PLModule loss and gradients, bf16 trunk through "
            "cast_bf16 (fp32 master params) on the CPU, every LSTM scan on "
            "the custom-VJP kernel route (set_fused_scan(False), "
            f"set_pallas_train(True)), {os.path.basename(config)} at full "
            f"width from {ckpt}, batch golden_batch({base.SEED}) "
            "(tools/jax_train_step_golden_seq.py)"),
        "config": config, "init_ckpt": ckpt,
        "batch": ("sound_bubble_tpu_torch.data.synth.golden_batch("
                  f"{base.SEED})"),
        "route": "custom-VJP kernels (lstm_pallas_train, "
                 "blstm_pallas_train)",
        **base.one_step("bf16", module, inputs, targets)}
    blocks = args["model_params"]["B"]
    # traced: the backward once a block, the forward twice (the primal and
    # the custom VJP's forward)
    if calls != {"lstm_seq_fwd": 2 * blocks, "lstm_seq_bwd": blocks,
                 "_blstm_fwd": 2 * blocks}:
        raise SystemExit(f"the step did not go through the kernels: {calls}")
    result["kernel_calls_traced"] = calls
    with open(os.path.join(base.REPO, OUT), "w") as f:
        json.dump(result, f, indent=1)
    print(f"loss {result['loss']:.9f}, grad norm {result['grad_norm']:.9f}, "
          f"{len(result['grad_norms'])} leaves, kernel calls {calls}, "
          f"{time.perf_counter() - t0:.1f} s -> {OUT}")


if __name__ == "__main__":
    main()
