"""Synthetic sound-bubble dataset generator (CLI), on the port.

    python -m sound_bubble_tpu_torch.generate_adaptive_dataset \
        <input_voice_dir> <output_path> [--split_path datasets/vctk_split.json]
        [--bg_voice_dir <wham dir> --split_path2 datasets/WHAM_split.json]
        [--tts_dir <LibriTTS dir>] [--n_outputs_train 12000]
        [--n_outputs_test 4000] [--n_workers 4] [--duration 5] ...

The counterpart of the repo's `generate_adaptive_dataset.py` (the same
arguments, sample dirs and `args.json`), on the port's native shoebox ISM
(`datagen/generate.py:generate_sample`): no pyroomacoustics, librosa,
soundfile, tqdm or pandas. Corpora: VCTK-style per-speaker wav dirs (+ an
optional LibriTTS tree and WHAM! noise dir); the split json maps each subset
(train / test / val) to its speaker dirs. The sample count is split into
thirds by in-bubble speaker count (0/1/2). Samples run in a thread pool on
numpy's global generator, as the reference does, so only `--n_workers 1`
gives the same tree for the same seed.
"""
import argparse
import glob
import json
import multiprocessing.dummy as mp
import os
import random
import traceback
from pathlib import Path

import numpy as np

from sound_bubble_tpu_torch.datagen.generate import (
    generate_sample, get_noise, load_voice_clip,
)


def seed_all(seed):
    np.random.seed(seed)
    random.seed(seed)


def handle_error(e):
    print("Error happen " + "!" * 30)
    print("".join(traceback.format_exception(e)), flush=True)


def list_tts_folders(directory):
    folder_names = {}
    for folder in os.listdir(directory):
        spk_dir = os.path.join(directory, folder)
        if not folder.isnumeric() or not os.path.isdir(spk_dir):
            continue
        sections = [os.path.join(spk_dir, f2) for f2 in os.listdir(spk_dir)
                    if f2.isnumeric()
                    and os.path.isdir(os.path.join(spk_dir, f2))]
        if sections:
            folder_names[folder] = sections
    return folder_names


def _select_voices(vctk_dirs, tts_data, n_voices, total_samples, sr):
    """Reference `random_select_speaker`: VCTK vs LibriTTS by speaker-count
    proportion (VCTK prob floored at 0.2)."""
    clips = []
    total_48 = total_samples * 2
    if tts_data:
        p_vctk = max(len(vctk_dirs) / (len(vctk_dirs) + len(tts_data)), 0.2)
    else:
        p_vctk = 1.0
    tts_keys = list(tts_data.keys()) if tts_data else []
    attempts = 0
    while len(clips) < n_voices and attempts < n_voices * 5:
        attempts += 1
        if np.random.rand() < p_vctk or not tts_keys:
            voice_dir = np.random.choice(vctk_dirs)
            speaker_id = str(voice_dir)[-4:]
            files = glob.glob(os.path.join(voice_dir, "*.wav"))
        else:
            speaker_id = np.random.choice(tts_keys)
            files = []
            for story in tts_data[speaker_id]:
                files.extend(glob.glob(os.path.join(story, "*.wav")))
        random.shuffle(files)
        if not files:
            continue
        audio = load_voice_clip(files, total_48, sr)
        if audio is not None:
            clips.append((audio, speaker_id))
    assert len(clips) == n_voices, "could not assemble enough voice clips"
    return clips


def _one_sample(vctk_dirs, tts_data, noise_list, n_inside, args, subdir, idx):
    out_dir = os.path.join(args.output_path, subdir, f"{idx:05d}")
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    total_samples = int(args.duration * args.sr)
    n_out = np.random.randint(args.n_out_min, args.n_out_max + 1)
    n_bg = np.random.randint(0, 2)
    clips = _select_voices(vctk_dirs, tts_data, n_inside + n_out,
                           total_samples, args.sr)
    noise = None
    if noise_list is not None and n_bg:
        noise = get_noise(noise_list, total_samples, args.sr)
    if subdir == "train":
        snr_range = (args.train_target_snr_min, args.train_target_snr_max)
    else:
        snr_range = (args.test_target_snr_min, args.test_target_snr_max)
    generate_sample(
        clips, noise, n_inside, output_dir=out_dir, sr=args.sr,
        duration=args.duration, n_out_range=(n_out, n_out),
        dis_threshold=args.dis_threshold, snr_range=snr_range,
        n_mics=args.n_mics,
        max_order_range=(args.max_order_min, args.max_order_max))
    return 0


def main(args: argparse.Namespace):
    seed_all(args.seed)
    failures = 0
    with open(args.split_path, "rb") as f:
        split_data = json.load(f)
    split_noise = {}
    if args.bg_voice_dir is not None:
        with open(args.split_path2, "rb") as f:
            split_noise = json.load(f)

    for subdir, voices in split_data.items():
        n_outputs = getattr(args, "n_outputs_" + subdir)
        if n_outputs <= 0:
            continue
        print(subdir)
        vctk_dirs = [os.path.join(args.input_voice_dir, x) for x in voices]
        noise_list = None
        if args.bg_voice_dir is not None:
            noise_list = [os.path.join(args.bg_voice_dir, x)
                          for x in split_noise[subdir]]
        tts_data = None
        if args.tts_dir is not None:
            sub = {"train": "train-clean-360", "test": "test-clean",
                   "val": "dev-clean"}[subdir]
            tts_data = list_tts_folders(os.path.join(args.tts_dir, sub))
        if len(vctk_dirs) == 0:
            raise ValueError("No voice files found")

        done, errors = [], []

        def finished(_):
            done.append(1)
            print(f"{subdir}: {len(done)}/{n_outputs} samples", flush=True)

        def failed(e):
            errors.append(e)
            handle_error(e)

        pool = mp.Pool(args.n_workers)
        total_num = args.start_index + n_outputs
        for i in range(n_outputs):
            gi = i + args.start_index
            n_inside = 0 if gi < total_num / 3 else (
                1 if gi < total_num / 3 * 2 else 2)
            pool.apply_async(
                _one_sample,
                args=(vctk_dirs, tts_data, noise_list, n_inside, args,
                      subdir, gi),
                callback=finished, error_callback=failed)
        pool.close()
        pool.join()
        failures += len(errors)

    with open(os.path.join(args.output_path, "args.json"), "w") as f:
        json.dump(args.__dict__, f, indent=4)
    if failures:
        raise SystemExit(f"{failures} sample(s) failed")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("input_voice_dir", type=str,
                   help="Directory with voice wav files")
    p.add_argument("output_path", type=str,
                   help="Output directory to write the synthetic dataset")
    p.add_argument("--tts_dir", type=str, default=None,
                   help="Directory path for LibriTTS files")
    p.add_argument("--bg_voice_dir", type=str, default=None,
                   help="Directory path for WHAM! noise wav files")
    p.add_argument("--split_path2", type=str,
                   default="datasets/WHAM_split.json")
    p.add_argument("--split_path", type=str,
                   default="datasets/vctk_split.json")
    p.add_argument("--n_mics", type=int, default=6)
    p.add_argument("--n_out_min", type=int, default=1)
    p.add_argument("--n_out_max", type=int, default=2)
    p.add_argument("--n_outputs_train", type=int, default=12000)
    p.add_argument("--n_outputs_test", type=int, default=4000)
    p.add_argument("--n_outputs_val", type=int, default=0)
    p.add_argument("--n_workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--sr", type=int, default=24000)
    p.add_argument("--start_index", type=int, default=0)
    p.add_argument("--dimensions", type=int, default=3, choices=(2, 3))
    p.add_argument("--train_target_snr_min", type=float, default=-10)
    p.add_argument("--train_target_snr_max", type=float, default=5)
    p.add_argument("--test_target_snr_min", type=float, default=-5)
    p.add_argument("--test_target_snr_max", type=float, default=5)
    p.add_argument("--max_order_min", type=int, default=10,
                   help="Image-source reflection order range (the "
                        "reference samples U(10,72); lower = faster)")
    p.add_argument("--max_order_max", type=int, default=72)
    p.add_argument("--dis_threshold", type=float, default=1.0)
    p.add_argument("--duration", type=float, default=5)
    return p


if __name__ == "__main__":
    main(parser().parse_args())
