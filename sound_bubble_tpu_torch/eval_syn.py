"""Synthetic test-set evaluation CLI on the port.

    python -m sound_bubble_tpu_torch.eval_syn <test_dir> <run_dir> \
        <output_dir> [--distance_threshold 1.0] [--sr 24000] [--save_id N] \
        [--device cuda|cpu]

Mirrors `src/eval_syn.py` (positionals, flags, printed lines and files):
each sample of `test_dir` goes through the run's PLModule `model`, the
offline `Net(pad=True)` forward, on the card unless `--device cpu`; the
rows (decay for an empty bubble; SNR, SI-SNR, SI-SDR and their improvements,
STOI and PESQ otherwise) go to `results.csv` (rewritten after every sample,
pandas' layout, written with the `csv` module), the rooms and speaker
geometry to `infos.json`, the arguments to `args.json`. `--save_id N`
evaluates sample `{N:06d}` alone and writes its wavs to `./debug/`.

With `SB_PALLAS_BLSTM=1` every intra BLSTM runs on the fused inference
kernel (row 5); the last line printed counts its launches.
"""
import argparse
import glob
import json
import os

import numpy as np

from sound_bubble_tpu_torch import utils
from sound_bubble_tpu_torch.evaluation import load_testcase as _load
from sound_bubble_tpu_torch.evaluation import (
    run_testcase_offline, write_records_csv)
from sound_bubble_tpu_torch.metrics.metrics import Metrics, compute_decay
from sound_bubble_tpu_torch.ops.kernels.lstm_kernel import blstm_infer
from sound_bubble_tpu_torch.ops.rnn import pallas_blstm_from_env
from sound_bubble_tpu_torch.test_samples import save_debug


def load_testcase(sample_dir, args):
    return _load(sample_dir, args.sr, args.distance_threshold)


def load_model(args):
    """The run's `model` handle on `args.device`, its intra BLSTMs on row 5
    under SB_PALLAS_BLSTM=1; full float32 (no TF32)."""
    utils.no_tf32()
    return utils.load_torch_pretrained(
        args.run_dir, device=args.device,
        pallas_blstm=pallas_blstm_from_env()).model


def print_launches():
    print("blstm_infer launches:", blstm_infer.launches)


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
    # at Metrics' 24 kHz whatever --sr is, as the JAX package's CLI
    pesq = Metrics("PESQ")
    stoi = Metrics("STOI")

    snr_ins, snris, sisdr_ins, sisdris, decays = [], [], [], [], []
    pesqs, stois, pesq_ins, stoi_ins = [], [], [], []
    records, infos = [], {}

    for sample_dir in sample_dirs:
        sample_name = os.path.basename(sample_dir)
        if args.save_id >= 0:
            sample_name = "{:06d}".format(args.save_id)
            sample_dir = os.path.join(args.test_dir, sample_name)
        print(f"Sample: {sample_name}", sample_dir)

        metadata, mixture, gt, tgt_speakers, spatial_info = load_testcase(
            sample_dir, args)
        n_tgt_speakers = len(tgt_speakers)
        output = run_testcase_offline(model, mixture,
                                      args.distance_threshold)

        row = {"sample": sample_name, "n_tgt_speakers": n_tgt_speakers}
        infos[sample_name] = {"room": metadata.get("room_info"),
                              "spatial": spatial_info}

        if n_tgt_speakers == 0:
            row["decay"] = float(compute_decay(est=output, mix=mixture[0:1]))
            print("Decay:", row["decay"])
            decays.append(row["decay"])
        else:
            mix0 = mixture[0:1]
            row["input_snr"] = float(snr(est=mix0, gt=gt, mix=mix0))
            row["snri"] = float(snr_i(est=output, gt=gt, mix=mix0))
            row["input_sisnr"] = float(si_snr(est=mix0, gt=gt, mix=mix0))
            row["sisnri"] = float(si_snr_i(est=output, gt=gt, mix=mix0))
            row["input_sisdr"] = float(si_sdr(est=mix0, gt=gt, mix=mix0))
            row["sisdri"] = float(si_sdr_i(est=output, gt=gt, mix=mix0))
            row["stoi_in"] = float(stoi(est=mix0, gt=gt, mix=mix0))
            row["pesq_in"] = float(pesq(est=mix0, gt=gt, mix=mix0))
            row["stoi"] = float(stoi(est=output, gt=gt, mix=mix0))
            row["pesq"] = float(pesq(est=output, gt=gt, mix=mix0))

            snr_ins.append(row["input_snr"])
            snris.append(row["snri"])
            sisdr_ins.append(row["input_sisdr"])
            sisdris.append(row["sisdri"])
            pesqs.append(row["pesq"])
            stois.append(row["stoi"])
            pesq_ins.append(row["pesq_in"])
            stoi_ins.append(row["stoi_in"])
            print("SI-SDR:", row["input_sisdr"], row["sisdri"],
                  "SNR: ", row["input_snr"], row["snri"])
            print("pesq_in=", row["pesq_in"], "pesq=", row["pesq"])
            print("stoi_in=", row["stoi_in"], "stoi=", row["stoi"])

        if args.save_id >= 0:
            save_debug(sample_name, mixture, output, gt, args.sr)
        records.append(row)
        if args.save_id < 0:
            # rewritten after every sample, so a run cut mid-set leaves
            # every finished sample on disk
            write_records_csv(os.path.join(args.output_dir, "results.csv"),
                              records)
        if args.save_id >= 0:
            break

    print("DECAY = ", np.mean(decays) if decays else np.nan)
    print("SNR: ", np.mean(snr_ins), np.mean(snris))
    print("SISDR: ", np.mean(sisdr_ins), np.mean(sisdris))
    print("pesq = ", np.mean(pesq_ins), np.mean(pesqs))
    print("stoi = ", np.mean(stoi_ins), np.mean(stois))

    if args.save_id < 0:
        write_records_csv(os.path.join(args.output_dir, "results.csv"),
                          records)
        with open(os.path.join(args.output_dir, "infos.json"), "w") as f:
            json.dump(infos, f, indent=4)
        with open(os.path.join(args.output_dir, "args.json"), "w") as f:
            json.dump(args.__dict__, f, indent=4)
    print_launches()


def parser():
    p = argparse.ArgumentParser()
    p.add_argument("test_dir", type=str, help="Path to test dataset")
    p.add_argument("run_dir", type=str, help="Path to model run")
    p.add_argument("output_dir", type=str, help="Path to store output files")
    p.add_argument("--distance_threshold", type=float, default=1.0,
                   help="Distance threshold to include/exclude speakers")
    p.add_argument("--sr", type=int, default=24000,
                   help="Project sampling rate")
    p.add_argument("--save_id", type=int, default=-1)
    p.add_argument("--use_cuda", action="store_true",
                   help="Accepted for CLI compatibility (see --device)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


if __name__ == "__main__":
    main(parser().parse_args())
