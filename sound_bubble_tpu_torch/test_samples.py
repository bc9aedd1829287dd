"""Serving CLI over the in-repo golden sample sets, on the port.

    python -m sound_bubble_tpu_torch.test_samples <test_dir> <run_dir> \
        --distance_threshold 1.0 [--save_id N] [--device cpu]

Mirrors `src/test_samples.py`: per-sample SI-SDRi/SNRi, STOI and PESQ (of
the mixture and of the estimate), the empty-bubble decay, and their means
over the directory (one bubble radius); `--save_id N` evaluates sample
`{N:06d}` alone and writes its mixture, estimate and target to
`./debug/{mix,est,gt}{N:06d}.wav`. Every sample is streamed chunk by chunk
through `FusedStreamer` (one whole-stack kernel launch per 8 ms chunk on the
card).
"""
import argparse
import glob
import os

import numpy as np

from sound_bubble_tpu_torch.evaluation import load_testcase, run_testcase
from sound_bubble_tpu_torch.metrics.metrics import Metrics, compute_decay
from sound_bubble_tpu_torch.runtime.fast_path import FusedStreamer
from sound_bubble_tpu_torch.utils import (
    load_pretrained, no_tf32, save_audio_file)

PERCEPTUAL = ("stoi_in", "stoi", "pesq_in", "pesq")


def save_debug(sample_name, mixture, output, gt, sr):
    """The sample's mixture (mic 0), estimate and target as
    ./debug/{mix,est,gt}<name>.wav, not rescaled."""
    os.makedirs("./debug", exist_ok=True)
    for tag, wav in (("mix", mixture[0:1]), ("est", output), ("gt", gt)):
        save_audio_file(f"./debug/{tag}{sample_name}.wav", wav,
                        sample_rate=sr, rescale=False)


def evaluate_dir(streamer, test_dir, distance_threshold, sr=24000,
                 verbose=True, perceptual=None, save_id=-1):
    """Stream every sample of `test_dir`; returns the per-sample lists
    (sisdri, snri, decay). `perceptual`: None, or a dict to which the STOI
    and PESQ of each sample with targets are appended (`PERCEPTUAL` keys;
    host-side numpy, seconds a sample). `save_id` >= 0: sample
    `{save_id:06d}` alone, written to ./debug/ (`save_debug`)."""
    snr, snr_i = Metrics("snr"), Metrics("snr_i")
    si_sdr, si_sdr_i = Metrics("si_sdr"), Metrics("si_sdr_i")
    # at Metrics' 24 kHz whatever `sr` is, as the JAX package's CLI
    stoi, pesq = Metrics("STOI"), Metrics("PESQ")
    sisdris, snris, decays = [], [], []
    sample_dirs = sorted(glob.glob(os.path.join(test_dir, "*")))
    if save_id >= 0:
        sample_dirs = [os.path.join(test_dir, "{:06d}".format(save_id))]
    for sample_dir in sample_dirs:
        if not os.path.isdir(sample_dir):
            continue
        sample_name = os.path.basename(sample_dir)
        if verbose:
            print(f"Sample: {sample_name}", sample_dir)
        _, mixture, gt, tgt_speakers, _ = load_testcase(
            sample_dir, sr, distance_threshold)
        output = run_testcase(streamer, mixture, distance_threshold)
        mix0 = mixture[0:1]
        if len(tgt_speakers) == 0:
            decay = float(compute_decay(est=output, mix=mix0))
            decays.append(decay)
            if verbose:
                print("Decay:", decay)
        else:
            input_snr = float(snr(est=mix0, gt=gt, mix=mix0))
            input_sisdr = float(si_sdr(est=mix0, gt=gt, mix=mix0))
            snris.append(float(snr_i(est=output, gt=gt, mix=mix0)))
            sisdris.append(float(si_sdr_i(est=output, gt=gt, mix=mix0)))
            if verbose:
                print("SI-SDR:", input_sisdr, sisdris[-1],
                      "SNR: ", input_snr, snris[-1])
            if perceptual is not None:
                row = {"stoi_in": stoi(est=mix0, gt=gt, mix=mix0),
                       "pesq_in": pesq(est=mix0, gt=gt, mix=mix0),
                       "stoi": stoi(est=output, gt=gt, mix=mix0),
                       "pesq": pesq(est=output, gt=gt, mix=mix0)}
                for key in PERCEPTUAL:
                    perceptual.setdefault(key, []).append(float(row[key]))
                if verbose:
                    print("pesq_in=", perceptual["pesq_in"][-1], "pesq=",
                          perceptual["pesq"][-1])
                    print("stoi_in=", perceptual["stoi_in"][-1], "stoi=",
                          perceptual["stoi"][-1])
        if save_id >= 0:
            save_debug(sample_name, mixture, output, gt, sr)
    return sisdris, snris, decays


def _mean(values):
    return np.mean(values) if values else np.nan


def main(args: argparse.Namespace):
    no_tf32()
    net = load_pretrained(args.run_dir, device=args.device)
    streamer = FusedStreamer(net, device=args.device)
    perceptual = {key: [] for key in PERCEPTUAL}
    sisdris, snris, decays = evaluate_dir(
        streamer, args.test_dir, args.distance_threshold, args.sr,
        perceptual=perceptual, save_id=args.save_id)
    print("DECAY = ", _mean(decays))
    print("SNRi: ", _mean(snris))
    print("SISDRi: ", _mean(sisdris))
    print("pesq = ", _mean(perceptual["pesq_in"]), _mean(perceptual["pesq"]))
    print("stoi = ", _mean(perceptual["stoi_in"]), _mean(perceptual["stoi"]))


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("test_dir", type=str, help="Path to test dataset")
    parser.add_argument("run_dir", type=str, help="Path to model run")
    parser.add_argument("--distance_threshold", type=float, default=1.0,
                        help="Distance threshold to include/exclude speakers")
    parser.add_argument("--sr", type=int, default=24000,
                        help="Project sampling rate")
    parser.add_argument("--save_id", type=int, default=-1,
                        help="Evaluate sample {save_id:06d} alone and write "
                             "its wavs to ./debug/")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    main(parser.parse_args())
