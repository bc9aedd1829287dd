"""Small helpers: devices, JSON, WAV reading and the run-dir loader.

Port of the parts of `sound_bubble_tpu/utils.py` and
`sound_bubble_tpu/data/audio_io.py` that serving needs. A run dir holds
`config.json` (its `pl_module_args.model_params` is the model configuration)
and `checkpoints/best.pt` (a pickled numpy tree, see `train/checkpoint.py`).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

# config `model` entries of the JAX package -> conditional or not
_CONDITIONAL_MODELS = {
    "sound_bubble_tpu.models.tfgridnet.model.net_from_params": True,
    "sound_bubble_tpu.models.tfgridnet.model.net_optim_from_params": False,
}


def resolve_device(device) -> torch.device:
    """torch.device for an entry point. A CUDA device with no card raises:
    the port never falls back to the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return device


def to_tensor(a, device) -> torch.Tensor:
    """float32 tensor on `device` from a tensor or an array-like."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.asarray(a, np.float32))
    return a.to(device=device, dtype=torch.float32)


def read_json(path):
    with open(path, "rb") as f:
        return json.load(f)


def read_audio_file(file_path, sr):
    """Read a wav as float32 [C, T] in [-1, 1] (librosa.load layout). The
    port does not resample: a file at another rate than `sr` raises."""
    import scipy.io.wavfile

    orig, data = scipy.io.wavfile.read(file_path)
    if sr is not None and orig != sr:
        raise ValueError(f"{file_path}: sample rate {orig}, expected {sr}")
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    data = data[None, :] if data.ndim == 1 else data.T   # scipy gives [T, C]
    return np.ascontiguousarray(data)


def load_pretrained(run_dir, device="cuda"):
    """run_dir/config.json + checkpoints/best.pt -> the port's `Net`, in
    eval mode, on `device`."""
    from sound_bubble_tpu_torch.models.tfgridnet.model import Net, make_config
    from sound_bubble_tpu_torch.train.checkpoint import load_checkpoint
    from sound_bubble_tpu_torch.weights import from_jax_params

    device = resolve_device(device)
    module_args = read_json(os.path.join(run_dir, "config.json"))[
        "pl_module_args"]
    model_name = module_args["model"]
    if model_name not in _CONDITIONAL_MODELS:
        raise NotImplementedError(f"model {model_name} is not ported yet")
    cfg = make_config(module_args["model_params"],
                      conditional=_CONDITIONAL_MODELS[model_name])
    ckpt_path = os.path.join(run_dir, "checkpoints", "best.pt")
    if not os.path.exists(ckpt_path):
        raise FileNotFoundError(
            f"Given run ({run_dir}) doesn't have any pretrained checkpoints!")
    net = Net(cfg)
    net.load_state_dict(from_jax_params(load_checkpoint(ckpt_path)["model"]))
    return net.to(device).eval()
