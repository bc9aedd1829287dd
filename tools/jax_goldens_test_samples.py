"""JAX reference numbers for the in-repo golden samples (`test_samples/`).

`runs/goldens_baseline.json` records the flagship on the reference's own
golden set, which is other audio than `test_samples/syn_{1m,1_5m,2m}`. This
script evaluates the same flagship with the JAX package, offline, in fp32 on
the CPU, over the in-repo samples (the protocol of `src/test_samples.py`) and
writes per-sample and per-radius SI-SDRi and decay to
`runs/goldens_test_samples_jax.json`, the numbers `chip_smoke.py` holds the
port's streamed results against:

    JAX_PLATFORMS=cpu python tools/jax_goldens_test_samples.py
"""
import json
import os
import sys

import jax
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from sound_bubble_tpu import utils  # noqa: E402
from sound_bubble_tpu.evaluation import load_testcase, run_testcase  # noqa: E402
from sound_bubble_tpu.metrics.metrics import Metrics, compute_decay  # noqa: E402

RUN_DIR = "runs/finetune_r5"
OUT = os.path.join(REPO, "runs", "goldens_test_samples_jax.json")
RADII = (("1m", 1.0), ("1_5m", 1.5), ("2m", 2.0))


def main():
    jax.config.update("jax_platforms", "cpu")
    model = utils.load_torch_pretrained(os.path.join(REPO, RUN_DIR)).model
    si_sdr_i = Metrics("si_sdr_i")
    result = {"_comment": (
        "JAX package, offline Net, fp32 on the CPU, flagship "
        f"{RUN_DIR} over test_samples/ (tools/jax_goldens_test_samples.py)"),
        "run_dir": RUN_DIR, "samples": {}, "sisdri": {}, "decay": {}}
    for radius, threshold in RADII:
        sisdris, decays = [], []
        rdir = os.path.join(REPO, "test_samples", f"syn_{radius}")
        for name in sorted(os.listdir(rdir)):
            _, mixture, gt, tgt, _ = load_testcase(
                os.path.join(rdir, name), 24000, threshold)
            out = run_testcase(model, mixture, None, threshold)
            if tgt:
                v = float(si_sdr_i(est=out, gt=gt, mix=mixture[0:1]))
                sisdris.append(v)
                result["samples"][f"{radius}/{name}"] = {"sisdri": v}
            else:
                v = float(compute_decay(est=out, mix=mixture[0:1]))
                decays.append(v)
                result["samples"][f"{radius}/{name}"] = {"decay": v}
            print(radius, name, result["samples"][f"{radius}/{name}"],
                  flush=True)
        result["sisdri"][radius] = float(np.mean(sisdris))
        result["decay"][radius] = float(np.mean(decays))
    with open(OUT, "w") as f:
        json.dump(result, f, indent=2)
        f.write("\n")
    print(json.dumps({k: result[k] for k in ("sisdri", "decay")}))


if __name__ == "__main__":
    main()
