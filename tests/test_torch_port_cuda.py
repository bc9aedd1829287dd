"""The CUDA stack-step kernel against its plain PyTorch version, on the card.

Marked `gpu`: each test decides inside itself whether a card is present and
skips here with a reason. This file imports neither JAX nor the JAX package,
so it also runs on a machine that has only PyTorch (run it there without the
repo's conftest, which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_port_cuda.py

Tolerance 1e-4 absolute: fp32 kernel vs fp32 plain version, which differ only
in summation order over D and 2H terms."""
from pathlib import Path

import numpy as np
import pytest
import torch

from sound_bubble_tpu_torch.models.tfgridnet.model import Net, NetConfig
from sound_bubble_tpu_torch.ops.kernels import stack_kernel as sk
from sound_bubble_tpu_torch.weights import param_tree

pytestmark = pytest.mark.gpu

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-4
SIZES = {"small": dict(stft_chunk_size=16, stft_pad_size=16, D=8, H=8, B=3),
         "full": dict(stft_chunk_size=192, stft_pad_size=96, D=32, H=64,
                      B=6)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _case(size, seed=0):
    cfg = NetConfig(conv_lstm=False, **SIZES[size])
    rng = np.random.default_rng(seed)
    net = Net(cfg)
    net.load_state_dict({
        k: torch.from_numpy(
            rng.standard_normal(v.shape).astype(np.float32) * 0.3)
        for k, v in net.state_dict().items()})
    F, D, H, B = cfg.n_freqs, cfg.D, cfg.H, cfg.B

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return (cfg, sk.pack_stack_params(cfg, param_tree(net)),
            dict(x=draw(F, D), h0=draw(B, F, H) * 0.5, c0=draw(B, F, H) * 0.5,
                 film_w=draw(B - 1, F, D), film_b=draw(B - 1, F, D)))


@pytest.mark.parametrize("use_film", [True, False])
@pytest.mark.parametrize("size", list(SIZES))
def test_kernel_matches_plain(size, use_film):
    dev = _card()
    cfg, packed, a = _case(size)
    packed = {k: v.to(dev) for k, v in packed.items()}
    a = {k: v.to(dev) for k, v in a.items()}
    fw = a["film_w"] if use_film else None
    fb = a["film_b"] if use_film else None
    before = sk.gridnet_stack_step.launches
    got = sk.gridnet_stack_step(packed, a["x"], a["h0"], a["c0"], fw, fb,
                                eps=cfg.eps)
    torch.cuda.synchronize()
    assert sk.gridnet_stack_step.launches == before + 1
    want = sk.gridnet_stack_step_ref(packed, a["x"], a["h0"], a["c0"], fw, fb,
                                     eps=cfg.eps)
    for g, w, name in zip(got, want, ("x", "h0", "c0")):
        assert g.shape == w.shape, name
        err = float((g - w).abs().max())
        assert err <= TOL, f"{name}: {err}"


def test_kernel_rejects_bad_operands():
    dev = _card()
    cfg, packed, a = _case("small")
    packed = {k: v.to(dev) for k, v in packed.items()}
    x, h0, c0 = (a[k].to(dev) for k in ("x", "h0", "c0"))
    with pytest.raises(TypeError, match="dtype"):
        sk.gridnet_stack_step(packed, x.double(), h0, c0)
    with pytest.raises(ValueError, match="not contiguous"):
        sk.gridnet_stack_step(packed, x.t().contiguous().t(), h0, c0)
    with pytest.raises(ValueError, match="expected cuda"):
        sk.gridnet_stack_step(packed, x, h0.cpu(), c0)
    with pytest.raises(ValueError, match="whh: on cpu"):
        sk.gridnet_stack_step({**packed, "whh": packed["whh"].cpu()}, x, h0,
                              c0)


def test_fused_streamer_on_card_matches_cpu():
    """The flagship, FusedStreamer on the card (one kernel launch per chunk)
    against FusedStreamer on the CPU (plain version), 4 chunks, 1e-4
    relative to the output's peak."""
    from sound_bubble_tpu_torch.runtime.fast_path import FusedStreamer
    from sound_bubble_tpu_torch.utils import load_pretrained

    dev = _card()
    run_dir = str(REPO / "runs" / "finetune_r5")
    rng = np.random.default_rng(1)
    cfg = load_pretrained(run_dir, device="cpu").cfg
    chunk, pad = cfg.stft_chunk_size, cfg.stft_pad_size
    x = rng.standard_normal((1, 6, chunk * 4 + pad)).astype(np.float32) * 0.1
    outs = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False      # full fp32 convolutions
    try:
        for device in ("cpu", dev):
            fs = FusedStreamer(load_pretrained(run_dir, device=device),
                               device=device)
            before = sk.gridnet_stack_step.launches
            outs[str(device)] = torch.cat(
                [fs.feed(x[..., k * chunk:k * chunk + chunk + pad]).cpu()
                 for k in range(4)], dim=-1)
            if device is dev:
                assert sk.gridnet_stack_step.launches == before + 4
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    want, got = outs["cpu"], outs[str(dev)]
    assert float((got - want).abs().max() / want.abs().max()) <= TOL
