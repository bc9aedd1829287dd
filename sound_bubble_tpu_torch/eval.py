"""Real-world test-set evaluation CLI on the port.

    python -m sound_bubble_tpu_torch.eval <test_dir> <run_dir> <output_dir> \
        [--distance_threshold 1.0 | -1 --gt_threshold 1.5] [--sr 24000] \
        [--device cuda|cpu]

Mirrors `src/eval.py`: `eval_syn` without the spatial bookkeeping and the
perceptual metrics; `--distance_threshold -1` evaluates a model without
distance conditioning (no `dis_embed`), the target then being the speakers
within `--gt_threshold`. Writes `results.csv` (pandas' layout, with the
`csv` module) and `args.json`. Offline `Net(pad=True)` forward on the card
unless `--device cpu`; with `SB_PALLAS_BLSTM=1` the intra BLSTMs run on row
5, and the last line printed counts its launches.
"""
import argparse
import glob
import json
import os

import numpy as np

from sound_bubble_tpu_torch.eval_syn import load_model, print_launches
from sound_bubble_tpu_torch.evaluation import load_testcase as _load
from sound_bubble_tpu_torch.evaluation import (
    run_testcase_offline, write_records_csv)
from sound_bubble_tpu_torch.metrics.metrics import Metrics, compute_decay


def load_testcase(sample_dir, args):
    threshold = (args.distance_threshold if args.distance_threshold != -1
                 else args.gt_threshold)
    return _load(sample_dir, args.sr, threshold)


def main(args: argparse.Namespace):
    os.makedirs(args.output_dir, exist_ok=True)
    sample_dirs = sorted(glob.glob(os.path.join(args.test_dir, "*")))
    model = load_model(args)

    snr = Metrics("snr")
    snr_i = Metrics("snr_i")
    si_snr = Metrics("si_snr")
    si_snr_i = Metrics("si_snr_i")
    si_sdr = Metrics("si_sdr")
    si_sdr_i = Metrics("si_sdr_i")

    records = []
    decays, snris, sisdris = [], [], []
    for sample_dir in sample_dirs:
        sample_name = os.path.basename(sample_dir)
        print(f"Sample: {sample_name}")
        metadata, mixture, gt, tgt_speakers, _ = load_testcase(sample_dir,
                                                               args)
        n_tgt_speakers = len(tgt_speakers)
        output = run_testcase_offline(model, mixture,
                                      args.distance_threshold)

        row = {"sample": sample_name, "n_tgt_speakers": n_tgt_speakers}
        if n_tgt_speakers == 0:
            row["decay"] = float(compute_decay(est=output, mix=mixture[0:1]))
            decays.append(row["decay"])
        else:
            mix0 = mixture[0:1]
            row["input_snr"] = float(snr(est=mix0, gt=gt, mix=mix0))
            row["snri"] = float(snr_i(est=output, gt=gt, mix=mix0))
            row["input_sisnr"] = float(si_snr(est=mix0, gt=gt, mix=mix0))
            row["sisnri"] = float(si_snr_i(est=output, gt=gt, mix=mix0))
            row["input_sisdr"] = float(si_sdr(est=mix0, gt=gt, mix=mix0))
            row["sisdri"] = float(si_sdr_i(est=output, gt=gt, mix=mix0))
            snris.append(row["snri"])
            sisdris.append(row["sisdri"])
            print("SI-SDR:", row["input_sisdr"], row["sisdri"],
                  "SNR:", row["input_snr"], row["snri"])
        records.append(row)

    print("DECAY = ", np.mean(decays) if decays else np.nan)
    print("SNRi: ", np.mean(snris), " SI-SDRi: ", np.mean(sisdris))

    write_records_csv(os.path.join(args.output_dir, "results.csv"), records)
    with open(os.path.join(args.output_dir, "args.json"), "w") as f:
        json.dump(args.__dict__, f, indent=4)
    print_launches()


def parser():
    p = argparse.ArgumentParser()
    p.add_argument("test_dir", type=str, help="Path to test dataset")
    p.add_argument("run_dir", type=str, help="Path to model run")
    p.add_argument("output_dir", type=str, help="Path to store output files")
    p.add_argument("--distance_threshold", type=float, default=1.0,
                   help="Distance threshold; -1 = unconditioned model")
    p.add_argument("--gt_threshold", type=float, default=1.5,
                   help="GT inclusion threshold when distance_threshold=-1")
    p.add_argument("--sr", type=int, default=24000)
    p.add_argument("--use_cuda", action="store_true",
                   help="Accepted for CLI compatibility (see --device)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


if __name__ == "__main__":
    main(parser().parse_args())
