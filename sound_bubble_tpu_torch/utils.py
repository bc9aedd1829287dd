"""Config plumbing, devices, seeding, JSON, WAV reading and writing and the
run-dir loaders (port of `sound_bubble_tpu/utils.py`).

The reference JSON configs name classes by dotted path: the JAX package's
(`sound_bubble_tpu.train.module.PLModule`), the reference's own (`src.*`)
and PyTorch's (`torch.optim.Adam`). `import_attr` maps every one of them that
is ported to the port's class through `ALIASES`, and raises for the others:
it never imports the JAX package. A run dir holds `config.json` (its
`pl_module_args.model_params` is the model configuration) and
`checkpoints/best.pt` (a pickled numpy tree, see `train/checkpoint.py`).
`load_pretrained` gives the run's `Net`; `load_torch_pretrained` the run's
`PLModule` (its `.model` is what the eval CLIs call), as the JAX package's.
"""
from __future__ import annotations

import importlib
import json
import os
import random

import numpy as np
import torch

_PORT = "sound_bubble_tpu_torch"
# JAX package's dotted path -> the port's
_PORTED = {
    "sound_bubble_tpu.models.tfgridnet.model.net_from_params":
        f"{_PORT}.models.tfgridnet.model.net_from_params",
    "sound_bubble_tpu.models.tfgridnet.model.net_optim_from_params":
        f"{_PORT}.models.tfgridnet.model.net_optim_from_params",
    "sound_bubble_tpu.train.module.PLModule": f"{_PORT}.train.module.PLModule",
    "sound_bubble_tpu.losses.snrlp.SNRLPLoss":
        f"{_PORT}.losses.snrlp.SNRLPLoss",
    "sound_bubble_tpu.losses.sdr.SNRLosses": f"{_PORT}.losses.sdr.SNRLosses",
    "sound_bubble_tpu.losses.multires_stft.MultiResoFuseLoss":
        f"{_PORT}.losses.multires_stft.MultiResoFuseLoss",
    "sound_bubble_tpu.data.dataset.DistanceEmbedDataset":
        f"{_PORT}.data.dataset.DistanceEmbedDataset",
    "sound_bubble_tpu.data.dataset.FixedThresholdDataset":
        f"{_PORT}.data.dataset.FixedThresholdDataset",
    **{f"sound_bubble_tpu.data.perturbations.{n}":
       f"{_PORT}.data.perturbations.{n}" for n in (
           "SpeedPerturbation", "SampleShiftPerturbation",
           "FrequencyMaskingPerturbation", "ChannelGainPerturbation",
           "ChannelDropPerturbation", "PeakNormPerturbation",
           "WhitePinkBrownPerturbation")},
    **{f"sound_bubble_tpu.train.optim.{n}": f"{_PORT}.train.optim.{n}"
       for n in ("Adam", "AdamW", "ReduceLROnPlateau", "StepLR",
                 "ExponentialLR", "ConstantLR", "LinearLR")},
}
# reference and PyTorch dotted paths -> the JAX package's
_REFERENCE = {
    "src.models.tfgridnet_realtime_clean_dis_embd3.net.Net":
        "sound_bubble_tpu.models.tfgridnet.model.net_from_params",
    "src.models.tfgridnet_realtime_clean_optim.net.Net":
        "sound_bubble_tpu.models.tfgridnet.model.net_optim_from_params",
    "src.hl_modules.distance_based_hl_module.PLModule":
        "sound_bubble_tpu.train.module.PLModule",
    "src.losses.SNRLP.SNRLPLoss": "sound_bubble_tpu.losses.snrlp.SNRLPLoss",
    "src.losses.SNRLosses.SNRLosses": "sound_bubble_tpu.losses.sdr.SNRLosses",
    "src.losses.MultiResoLoss.MultiResoFuseLoss":
        "sound_bubble_tpu.losses.multires_stft.MultiResoFuseLoss",
    "src.datasets.general_multisrc_dataset_dis_embed.Dataset":
        "sound_bubble_tpu.data.dataset.DistanceEmbedDataset",
    "src.datasets.multisrc_dataset_with_perturbations.Dataset":
        "sound_bubble_tpu.data.dataset.FixedThresholdDataset",
    **{f"src.datasets.perturbations.{n}.{n}":
       f"sound_bubble_tpu.data.perturbations.{n}" for n in (
           "SpeedPerturbation", "SampleShiftPerturbation",
           "FrequencyMaskingPerturbation", "ChannelGainPerturbation",
           "ChannelDropPerturbation", "PeakNormPerturbation",
           "WhitePinkBrownPerturbation")},
    "torch.optim.Adam": "sound_bubble_tpu.train.optim.Adam",
    "torch.optim.AdamW": "sound_bubble_tpu.train.optim.AdamW",
    **{f"torch.optim.lr_scheduler.{n}": f"sound_bubble_tpu.train.optim.{n}"
       for n in ("ReduceLROnPlateau", "StepLR", "ExponentialLR",
                 "ConstantLR", "LinearLR")},
}
ALIASES = {**_PORTED, **{k: _PORTED[v] for k, v in _REFERENCE.items()
                         if v in _PORTED}}


def import_attr(import_path: str):
    """The port's object for a config's dotted path (see `ALIASES`). A path
    into the JAX package, the reference or `torch.optim` that is not ported
    raises NotImplementedError."""
    path = ALIASES.get(import_path, import_path)
    root = path.split(".")[0]
    if root in ("sound_bubble_tpu", "src") or path.startswith("torch.optim"):
        raise NotImplementedError(f"{import_path} is not ported yet")
    module, attr = path.rsplit(".", 1)
    return getattr(importlib.import_module(module), attr)


def seed_all(seed: int):
    """Seed Python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def cast_bf16(params):
    """Every float32 tensor of a param dict (a flat state dict, or the
    nested dict of `weights.param_tree`) cast to bfloat16, other leaves as
    they are: the bf16 forward of mixed precision (JAX `utils.cast_bf16`).
    The float32 master params stay outside; the cast is differentiable, so
    their gradients come back through it in float32."""
    if isinstance(params, dict):
        return {k: cast_bf16(v) for k, v in params.items()}
    if isinstance(params, torch.Tensor) and params.dtype == torch.float32:
        return params.to(torch.bfloat16)
    return params


def resolve_device(device) -> torch.device:
    """torch.device for an entry point. A CUDA device with no card raises:
    the port never falls back to the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return device


def no_tf32():
    """Full float32 products on the card, as the JAX package computes fp32:
    PyTorch's default lets cuDNN run float32 convolutions in TF32 (three
    decimal digits). The CLIs call it at start."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_tensor(a, device) -> torch.Tensor:
    """float32 tensor on `device` from a tensor or an array-like."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.asarray(a, np.float32))
    return a.to(device=device, dtype=torch.float32)


class Params:
    """JSON config with attribute access (reference `Params`)."""

    def __init__(self, json_path):
        with open(json_path) as f:
            self.__dict__.update(json.load(f))

    def save(self, json_path):
        with open(json_path, "w") as f:
            json.dump(self.__dict__, f, indent=4)

    def update(self, json_path):
        with open(json_path) as f:
            self.__dict__.update(json.load(f))

    @property
    def dict(self):
        return self.__dict__


def read_json(path):
    with open(path, "rb") as f:
        return json.load(f)


def read_audio_file(file_path, sr):
    """Read a wav as float32 [C, T] in [-1, 1] (librosa.load layout),
    resampled to `sr` when the file has another rate (polyphase, as the JAX
    package's `utils.read_audio_file`)."""
    from sound_bubble_tpu_torch.data.audio_io import read_audio
    from sound_bubble_tpu_torch.data.resample import resample_poly_np

    data, orig = read_audio(file_path)
    if sr is not None and orig != sr:
        data = resample_poly_np(data, sr, orig)
    return data


def write_audio_file(file_path, data, sr, subtype="PCM_16"):
    """Write [C, T] (or [T]) float audio as a wav (PCM_16 or FLOAT)."""
    from sound_bubble_tpu_torch.data.audio_io import write_audio_file as _w

    _w(file_path, data, sr, subtype)


def save_audio_file(file_path, wavform, sample_rate=48000, rescale=True):
    """Reference `save_audio_file_torch`: peak-normalize to 0.9 (when
    `rescale`), then write."""
    if isinstance(wavform, torch.Tensor):
        wavform = wavform.detach().cpu().numpy()
    wavform = np.asarray(wavform)
    if rescale:
        wavform = wavform / np.max(wavform) * 0.9
    write_audio_file(file_path, wavform, sample_rate)


def load_net(experiment_config, return_params: bool = False, **module_args):
    """The PLModule a config describes, with no checkpoint (its
    `init_ckpt` ignored). `module_args` go to the PLModule (`device`,
    `lstm_scan`, `pallas_blstm`)."""
    params = Params(experiment_config)
    params.pl_module_args["init_ckpt"] = None
    pl_module = import_attr(params.pl_module)(**params.pl_module_args,
                                              **module_args)
    if return_params:
        return pl_module, read_json(experiment_config)
    return pl_module


def load_torch_pretrained(run_dir, return_params: bool = False,
                          **module_args):
    """run_dir/config.json + checkpoints/best.pt -> the run's PLModule
    (reference `load_torch_pretrained`) with the checkpoint's weights and
    epoch; `module_args` as `load_net`'s, the device "cuda" unless they say
    otherwise. The optimizer state stays fresh: a JAX package's checkpoint
    holds optax's, which the port's optimizers do not read, and evaluation
    needs none."""
    from sound_bubble_tpu_torch.train.checkpoint import load_checkpoint
    from sound_bubble_tpu_torch.weights import from_jax_params

    config_path = os.path.join(run_dir, "config.json")
    ckpt_path = os.path.join(run_dir, "checkpoints", "best.pt")
    if not os.path.exists(ckpt_path):
        raise FileNotFoundError(
            f"Given run ({run_dir}) doesn't have any pretrained checkpoints!")
    pl_module, params = load_net(config_path, return_params=True,
                                 **module_args)
    state = load_checkpoint(ckpt_path)
    pl_module.net.load_state_dict(from_jax_params(state["model"]))
    pl_module.epoch = state.get("current_epoch", 0)
    print("Loaded module at epoch", pl_module.epoch)
    if return_params:
        return pl_module, params
    return pl_module


def load_pretrained(run_dir, device="cuda"):
    """run_dir/config.json + checkpoints/best.pt -> the port's `Net`, in
    eval mode, on `device`."""
    from sound_bubble_tpu_torch.train.checkpoint import load_checkpoint
    from sound_bubble_tpu_torch.weights import from_jax_params

    device = resolve_device(device)
    module_args = read_json(os.path.join(run_dir, "config.json"))[
        "pl_module_args"]
    net = import_attr(module_args["model"])(**module_args["model_params"])
    ckpt_path = os.path.join(run_dir, "checkpoints", "best.pt")
    if not os.path.exists(ckpt_path):
        raise FileNotFoundError(
            f"Given run ({run_dir}) doesn't have any pretrained checkpoints!")
    net.load_state_dict(from_jax_params(load_checkpoint(ckpt_path)["model"]))
    return net.to(device).eval()
