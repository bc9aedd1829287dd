"""Port hygiene: the port and chip_smoke.py import nothing of JAX, and
neither tqdm nor pandas (the card machine has neither); the flagship
checkpoint loads with optax, flax and jax blocked; entry points never fall
back to the CPU on their own; nothing builds at import."""
import ast
import io
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax  # noqa: F401  (kept on the CPU by tests/conftest.py)
import numpy as np
import pytest
import torch

from sound_bubble_tpu_torch.models.tfgridnet.model import Net, NetConfig
from sound_bubble_tpu_torch.ops.kernels import _build
from sound_bubble_tpu_torch.runtime.fast_path import FusedStreamer
from sound_bubble_tpu_torch.runtime.streaming import ModelWrapper
from sound_bubble_tpu_torch.train import checkpoint
from sound_bubble_tpu_torch.utils import load_pretrained

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sound_bubble_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "sound_bubble_tpu", "tqdm",
             "pandas"}
BLOCK = ("import sys\n"
         "for m in ('jax', 'jaxlib', 'flax', 'optax', 'sound_bubble_tpu'):\n"
         "    sys.modules[m] = None\n")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_exist():
    names = {p.relative_to(REPO).as_posix() for p in _port_sources()}
    assert "chip_smoke.py" in names
    assert "sound_bubble_tpu_torch/ops/kernels/stack_kernel.py" in names
    assert "sound_bubble_tpu_torch/ops/kernels/lstm_slab.py" in names
    assert "sound_bubble_tpu_torch/ops/kernels/lstm_train_kernel.py" in names
    assert "sound_bubble_tpu_torch/train_pt.py" in names
    assert "sound_bubble_tpu_torch/losses/multires_stft.py" in names
    assert (PORT / "csrc" / "stack_walk.cu").exists()
    assert (PORT / "csrc" / "lstm_slab.cu").exists()
    assert (PORT / "csrc" / "lstm_seq.cu").exists()
    assert (PORT / "csrc" / "lstm_infer.cu").exists()
    assert "sound_bubble_tpu_torch/ops/kernels/lstm_kernel.py" in names
    assert "sound_bubble_tpu_torch/eval_syn.py" in names
    assert "sound_bubble_tpu_torch/eval.py" in names
    for mod in ("datagen/ism.py", "datagen/mixing.py", "datagen/generate.py",
                "datagen/on_device.py", "datagen/campaign.py",
                "datagen/voice.py", "ops/noise.py",
                "generate_adaptive_dataset.py", "make_eval_set.py",
                "pregen_pool.py"):
        assert f"sound_bubble_tpu_torch/{mod}" in names, mod


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_imports(path):
    bad = sorted(set(_imports(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def _run_blocked(code):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", BLOCK + code], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=240)


def test_flagship_checkpoint_loads_without_optax_flax_jax():
    proc = _run_blocked(
        "from sound_bubble_tpu_torch.train.checkpoint import "
        "load_checkpoint\n"
        "ck = load_checkpoint('runs/finetune_r5/checkpoints/best.pt')\n"
        "w = ck['model']['block0']['intra']['blstm']['fwd']['w_hh']\n"
        "print(tuple(w.shape), w.dtype)\n"
        "assert all(sys.modules[m] is None for m in ('jax', 'optax'))\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[0] == "(64, 256) float32"


def test_every_port_module_imports_without_jax():
    proc = _run_blocked(
        "import importlib, pkgutil, sound_bubble_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'sound_bubble_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "from sound_bubble_tpu_torch.ops.kernels import _build\n"
        "assert _build._lib is None  # nothing built at import\n"
        "assert 'triton' not in sys.modules\n"
        "print(len(mods))\n")
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15


def test_numpy_core_fallback(monkeypatch):
    """Checkpoints written under numpy >= 2 name `numpy._core`; where that
    does not import, the loader maps it to `numpy.core`."""
    real = checkpoint.importlib.import_module

    def no_private_core(name, *a, **k):
        if name.startswith("numpy._core"):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(checkpoint.importlib, "import_module",
                        no_private_core)
    unpickler = checkpoint._Unpickler(io.BytesIO())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got = unpickler.find_class("numpy._core.multiarray", "_reconstruct")
    assert got is np.core.multiarray._reconstruct


def test_foreign_globals_become_placeholders():
    unpickler = checkpoint._Unpickler(io.BytesIO())
    cls = unpickler.find_class("optax._src.transform", "ScaleByAdamState")
    obj = cls.__new__(cls, 1, 2)
    assert isinstance(obj, checkpoint.Placeholder) and obj.args == (1, 2)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    "FusedStreamer", "ModelWrapper", "load_pretrained",
    "streaming_inference_scan", "load_torch_pretrained", "eval_syn"])
def test_default_device_without_card_raises(entry, no_card, tmp_path):
    from sound_bubble_tpu_torch import eval_syn
    from sound_bubble_tpu_torch.runtime.streaming import (
        streaming_inference_scan)
    from sound_bubble_tpu_torch.utils import load_torch_pretrained

    net = Net(NetConfig(conv_lstm=False, B=2, D=8, H=8))
    run_dir = str(REPO / "runs" / "finetune_r5")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "FusedStreamer":
            FusedStreamer(net)
        elif entry == "ModelWrapper":
            ModelWrapper(net)
        elif entry == "streaming_inference_scan":
            streaming_inference_scan(net, np.zeros((1, 6, 400)), 128, 64)
        elif entry == "load_torch_pretrained":
            load_torch_pretrained(run_dir)
        elif entry == "eval_syn":
            eval_syn.main(eval_syn.parser().parse_args([
                str(REPO / "test_samples" / "syn_1m"), run_dir,
                str(tmp_path / "out")]))
        else:
            load_pretrained(run_dir)


def test_datagen_default_device_without_card_raises(no_card, tmp_path):
    from sound_bubble_tpu_torch import make_eval_set
    from sound_bubble_tpu_torch.datagen import campaign

    with pytest.raises(RuntimeError, match="no CUDA device"):
        campaign.build_pool(1, sr=8000, rir_len=1000, order_range=(2, 3),
                            method="device", verbose=False)
    args = make_eval_set.parser().parse_args(["--out", str(tmp_path / "e"),
                                              "--n", "1"])
    assert args.device == "cuda" and args.voice == "formant"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_set.main(args)
    assert not (tmp_path / "e").exists()


def test_trainer_default_device_without_card_raises(no_card):
    from sound_bubble_tpu_torch import train_pt

    args = train_pt.parse_args(["--config", str(
        REPO / "syn_experiments" / "pretrain_stage.json"), "--run_dir",
        str(REPO / "runs" / "never_written")])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_pt.train(args)
    assert not (REPO / "runs" / "never_written").exists()


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
