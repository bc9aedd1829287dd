"""Faults of the port against the JAX package, repaired, on the CPU:

- `utils.read_audio_file` resamples a wav at another rate (16 kHz here) to
  the rate asked for, as the JAX package's does (the same polyphase filter:
  1e-6 absolute);
- `PLModule` raises on a sample that has target speakers but an all-zero
  target, where the JAX package asserts (`train/module.py`), for the train
  and the validation step alike.
- `utils.read_audio_file` and `data.audio_io.read_audio_file` parse each
  wav once (the rate and the samples come from one read).
(The bf16 trunk's serving raising NotImplementedError is in
tests/test_torch_port_model.py.)"""
import json
import os

import numpy as np
import pytest
import scipy.io.wavfile

from sound_bubble_tpu import utils as jutils
from sound_bubble_tpu_torch import utils as tutils
from sound_bubble_tpu_torch.data.synth import golden_batch
from sound_bubble_tpu_torch.train.module import PLModule
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "syn_experiments", "pretrain_stage.json")


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_read_audio_file_resamples_like_jax(tmp_path, dtype, rng):
    path = str(tmp_path / "a16k.wav")
    x = 0.3 * rng.standard_normal((1600, 2))
    scipy.io.wavfile.write(path, 16000, (x * 32767).astype(np.int16)
                           if dtype is np.int16 else x.astype(np.float32))
    got = tutils.read_audio_file(path, 24000)
    want = jutils.read_audio_file(path, 24000)
    assert got.shape == want.shape == (2, 2400)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the file's own rate: no resampling
    assert tutils.read_audio_file(path, 16000).shape == (2, 1600)


def test_each_wav_is_parsed_once(tmp_path, monkeypatch, rng):
    from sound_bubble_tpu_torch.data import audio_io

    path = str(tmp_path / "a16k.wav")
    scipy.io.wavfile.write(path, 16000, (0.3 * rng.standard_normal(
        (1600, 2)) * 32767).astype(np.int16))
    reads = []
    read = scipy.io.wavfile.read
    monkeypatch.setattr(scipy.io.wavfile, "read",
                        lambda p, *a, **k: reads.append(p) or read(p, *a, **k))
    assert tutils.read_audio_file(path, 24000).shape == (2, 2400)
    assert audio_io.read_audio_file(path, downsample=2).shape == (2, 800)
    assert reads == [path, path]


@pytest.mark.parametrize("step", ["train", "val"])
def test_all_zero_target_with_speakers_raises(step):
    with open(CONFIG) as f:
        args = json.load(f)["pl_module_args"]
    args["model_params"] = dict(args["model_params"], D=8, H=8, B=2)
    np.random.seed(0)
    module = PLModule(**args, device="cpu")
    inputs, targets = golden_batch(0)
    n = 2400                                        # 0.1 s of each clip
    inputs = {k: v[..., :n] if k == "mixture" else v
              for k, v in inputs.items()}
    targets = dict(targets, target=targets["target"][..., :n].copy())
    assert targets["num_target_speakers"][0] > 0
    targets["target"][0] = 0.0
    run = module.training_step if step == "train" else module.validation_step
    with pytest.raises(ValueError, match="all-zero target"):
        run((inputs, targets))
