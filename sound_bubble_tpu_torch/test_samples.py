"""Serving CLI over the in-repo golden sample sets, on the port.

    python -m sound_bubble_tpu_torch.test_samples <test_dir> <run_dir> \
        --distance_threshold 1.0 [--device cpu]

Mirrors `src/test_samples.py`: per-sample SI-SDRi/SNRi, the empty-bubble
decay, and their means over the directory (one bubble radius). Every sample
is streamed chunk by chunk through `FusedStreamer` (one whole-stack kernel
launch per 8 ms chunk on the card). STOI and PESQ are not ported yet.
"""
import argparse
import glob
import os

import numpy as np

from sound_bubble_tpu_torch.evaluation import load_testcase, run_testcase
from sound_bubble_tpu_torch.metrics.metrics import Metrics, compute_decay
from sound_bubble_tpu_torch.runtime.fast_path import FusedStreamer
from sound_bubble_tpu_torch.utils import load_pretrained


def evaluate_dir(streamer, test_dir, distance_threshold, sr=24000,
                 verbose=True):
    """Stream every sample of `test_dir`; returns the per-sample lists
    (sisdri, snri, decay)."""
    snr, snr_i = Metrics("snr"), Metrics("snr_i")
    si_sdr, si_sdr_i = Metrics("si_sdr"), Metrics("si_sdr_i")
    sisdris, snris, decays = [], [], []
    for sample_dir in sorted(glob.glob(os.path.join(test_dir, "*"))):
        if not os.path.isdir(sample_dir):
            continue
        if verbose:
            print(f"Sample: {os.path.basename(sample_dir)}", sample_dir)
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
    return sisdris, snris, decays


def main(args: argparse.Namespace):
    net = load_pretrained(args.run_dir, device=args.device)
    streamer = FusedStreamer(net, device=args.device)
    sisdris, snris, decays = evaluate_dir(
        streamer, args.test_dir, args.distance_threshold, args.sr)
    print("DECAY = ", np.mean(decays) if decays else np.nan)
    print("SNRi: ", np.mean(snris) if snris else np.nan)
    print("SISDRi: ", np.mean(sisdris) if sisdris else np.nan)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("test_dir", type=str, help="Path to test dataset")
    parser.add_argument("run_dir", type=str, help="Path to model run")
    parser.add_argument("--distance_threshold", type=float, default=1.0,
                        help="Distance threshold to include/exclude speakers")
    parser.add_argument("--sr", type=int, default=24000,
                        help="Project sampling rate")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    main(parser.parse_args())
