"""Port parity, the finetune loss: `losses/multires_stft.py`
(`a_weighting_fir`, `fir_filter`, `stft_mag`, `STFTLoss`,
`MultiResolutionSTFTLoss`, `MultiResoFuseLoss`) and the `Multi_Reso_L1`
metric against the JAX package on the same numpy inputs, on the CPU.

Values to 1e-4 relative (the loss of the reference configs is ~1e2: a sum
of lin-mag L1 terms weighted 20 and an L1 weighted 10, fp32 FFTs in another
order); gradients to 1e-4 of their peak. With `perceptual_weighting` on and
off, per-sample (w_sc = 0, the configs' setting) and batch-scalar
(w_sc > 0) forms. The log-magnitude term (w_log_mag, 0 in every config of
the repo) has the gradient 1/|X| on the quietest bins, where the two FFTs'
last digits and the clamp at eps decide: its values are held to 1e-4
relative, its gradients to 1e-2 of their peak (measured: 3.7e-3 with the
A-weighting, which leaves the lowest bins near the clamp)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_bubble_tpu.losses import multires_stft as jl
from sound_bubble_tpu.metrics import metrics as jm
from sound_bubble_tpu_torch.losses import multires_stft as tl
from sound_bubble_tpu_torch.metrics import metrics as tm
from sound_bubble_tpu_torch.utils import import_attr
from torch_port_threads import one_torch_thread  # noqa: F401

REL = 1e-4
# the finetune configs' loss_params
FINETUNE = dict(l1_ratio=10, sample_rate=24000, w_sc=0, w_log_mag=0,
                w_lin_mag=20)
SCALAR = dict(l1_ratio=1, sample_rate=24000, w_sc=1, w_log_mag=0,
              w_lin_mag=1)
LOG_MAG = dict(l1_ratio=0, sample_rate=24000, w_sc=0, w_log_mag=1,
               w_lin_mag=0)
LOG_MAG_GRAD_REL = 1e-2


def _batch(seed=0, b=3, n=6000):
    rng = np.random.default_rng(seed)
    gt = (0.3 * rng.standard_normal((b, 1, n))).astype(np.float32)
    gt[1] = 0.0                                   # an empty-bubble target
    est = (gt + 0.2 * rng.standard_normal((b, 1, n))).astype(np.float32)
    return est, gt


def test_a_weighting_fir_and_filter_match_jax():
    taps = tl.a_weighting_fir(24000)
    np.testing.assert_array_equal(taps, jl.a_weighting_fir(24000))
    assert taps.shape == (101,)
    est, _ = _batch()
    got = tl.fir_filter(torch.from_numpy(est), torch.from_numpy(taps))
    want = jl.fir_filter(jnp.asarray(est), jnp.asarray(taps))
    assert tuple(got.shape) == want.shape == est.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("fft,hop,win", [(1024, 120, 600), (512, 50, 240)])
def test_stft_mag_matches_jax(fft, hop, win):
    est, _ = _batch()
    got = tl.stft_mag(torch.from_numpy(est), fft, hop, win).numpy()
    want = np.asarray(jl.stft_mag(jnp.asarray(est), fft, hop, win))
    assert got.shape == want.shape == (3, 1, fft // 2 + 1, 6000 // hop + 1)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                               rtol=0)


@pytest.mark.parametrize("weighting", [True, False])
@pytest.mark.parametrize("params", ["finetune", "scalar", "log_mag"])
def test_multireso_fuse_loss_matches_jax(params, weighting):
    kw = dict({"finetune": FINETUNE, "scalar": SCALAR,
               "log_mag": LOG_MAG}[params], perceptual_weighting=weighting)
    est, gt = _batch(1)
    jloss = jl.MultiResoFuseLoss(**kw)
    # gt as an argument, not a closed-over constant that XLA would fold
    want_g = jax.grad(lambda e, g: jnp.sum(jloss(e, g)))(
        jnp.asarray(est), jnp.asarray(gt))
    want_v = np.asarray(jloss(jnp.asarray(est), jnp.asarray(gt)))
    te = torch.from_numpy(est).requires_grad_()
    got = tl.MultiResoFuseLoss(**kw)(te, torch.from_numpy(gt))
    got.sum().backward()
    assert got.shape == want_v.shape == (() if params == "scalar" else (3,))
    np.testing.assert_allclose(got.detach().numpy(), want_v, rtol=REL,
                               atol=0)
    g = np.asarray(want_g)
    rel = LOG_MAG_GRAD_REL if params == "log_mag" else REL
    np.testing.assert_allclose(te.grad.numpy(), g,
                               atol=rel * np.abs(g).max(), rtol=0)


def test_multi_reso_l1_metric_and_alias():
    est, gt = _batch(2)
    kw = dict(FINETUNE, perceptual_weighting=True)
    got = tm.Metrics("Multi_Reso_L1", **kw)(est, gt, gt).numpy()
    want = np.asarray(jm.Metrics("Multi_Reso_L1", **kw)(est, gt, gt))
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)
    # the finetune configs' dotted paths resolve to the port
    for name in ("sound_bubble_tpu.losses.multires_stft.MultiResoFuseLoss",
                 "src.losses.MultiResoLoss.MultiResoFuseLoss"):
        assert import_attr(name) is tl.MultiResoFuseLoss
