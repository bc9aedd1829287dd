"""Port parity, the model: the port's offline `Net` against the JAX `Net` on
the same weights (`from_jax_params`) and the same numpy inputs, on the CPU.
The streaming paths are in tests/test_torch_port_streaming.py.

Tolerance 1e-4 absolute on the SMALL config of tests/test_fast_path.py, the
repo's bar for whole-model parity."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_bubble_tpu.models.tfgridnet.model import make_net
from sound_bubble_tpu_torch.models.tfgridnet.model import Net, make_config
from sound_bubble_tpu_torch.runtime.fast_path import FusedStreamer
from sound_bubble_tpu_torch.weights import from_jax_params
from torch_port_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
SMALL = dict(stft_chunk_size=32, stft_pad_size=16, num_ch=6, D=8, B=3, H=8,
             L=2, E=2, use_attn=False, chunk_causal=True, use_first_ln=True,
             merge_method="early_cat", conv_lstm=False, dis_type="conv3")
VARIANTS = {"cond": ({}, True), "uncond": ({}, False),
            "masking": ({"spectral_masking": True}, True),
            # the edge configuration's intra path (F = 25: s = 5 divides
            # it, s = 4 leaves a ragged tail), unconditioned as it ships
            "conv_uncond": ({"conv_lstm": True, "lstm_down": 5}, False),
            "conv_ragged": ({"conv_lstm": True, "lstm_down": 4}, True)}
DIS = np.asarray([[0.0, 1.0, 0.0]], np.float32)


def _pair(variant, x):
    """(JAX net, JAX params, port Net) with the same weights."""
    extra, conditional = VARIANTS[variant]
    model_params = {**SMALL, **extra}
    jnet = make_net(model_params, conditional=conditional)
    inputs = {"mixture": jnp.asarray(x[..., :jnet.cfg.n_fft])}
    if conditional:
        inputs["dis_embed"] = jnp.asarray(DIS)
    params = jnet.init(jax.random.PRNGKey(0), inputs)["params"]
    net = Net(make_config(model_params, conditional=conditional))
    net.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    return jnet, params, net.eval()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_offline_net_matches_jax(variant, rng):
    # 7.5 chunks: exercises the mod padding and its trim
    x = rng.standard_normal((2, 6, 32 * 7 + 16)).astype(np.float32) * 3
    jnet, params, net = _pair(variant, x)
    inputs = {"mixture": jnp.asarray(x)}
    tin = {"mixture": torch.from_numpy(x)}
    if jnet.cfg.conditional:
        inputs["dis_embed"] = jnp.asarray(np.repeat(DIS, 2, axis=0))
        tin["dis_embed"] = torch.from_numpy(np.repeat(DIS, 2, axis=0))
    want = jnet.apply({"params": params}, inputs)
    with torch.no_grad():
        got = net(tin)
    assert tuple(got["output"].shape) == want["output"].shape == (2, 1, 240)
    np.testing.assert_allclose(got["output"].numpy(),
                               np.asarray(want["output"]), atol=TOL, rtol=0)
    for i in range(jnet.cfg.B):
        for k in ("h0", "c0"):
            np.testing.assert_allclose(
                got["next_state"]["gridnet_bufs"][f"buf{i}"][k].numpy(),
                np.asarray(want["next_state"]["gridnet_bufs"][f"buf{i}"][k]),
                atol=TOL, rtol=0)


def test_fused_streamer_resets_and_switches_embedding(rng):
    chunk, pad = SMALL["stft_chunk_size"], SMALL["stft_pad_size"]
    x = rng.standard_normal((1, 6, chunk * 3 + pad)).astype(np.float32)
    net = Net(make_config(SMALL))
    net.load_state_dict({
        k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
        for k, v in net.state_dict().items()})
    fs = FusedStreamer(net, dis_embed=DIS, device="cpu")
    first = [fs.feed(x[..., k * chunk:k * chunk + chunk + pad])
             for k in range(3)]
    fs.reset()
    again = [fs.feed(x[..., k * chunk:k * chunk + chunk + pad])
             for k in range(3)]
    for a, b in zip(first, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    fs.set_dis_embed([[1.0, 0.0, 0.0]])
    fs.reset()
    other = fs.feed(x[..., :chunk + pad])
    assert not torch.equal(other, first[0])


@pytest.mark.parametrize("change", [{"use_attn": True},
                                    {"compute_dtype": "bf16"},
                                    {"stft_back_pad": 8},
                                    {"dis_type": "linear2"}])
def test_unported_variants_raise(change):
    """Every variant of the JAX `NetConfig` builds (attention, the
    look-back decode and the linear dis_types are ported); the one corner
    not ported yet, the bf16 trunk with attention, raises naming its
    ROADMAP item (Queue 1 item 15) whatever else the config changes. The
    bf16 trunk alone is ported (the model builds); serving it through the
    stack kernels is not (Queue 2 item 3), and FusedStreamer raises rather
    than serve it in fp32."""
    net = Net(make_config({**SMALL, **change}))
    if "compute_dtype" in change:
        with pytest.raises(NotImplementedError, match="Queue 2 item 3"):
            FusedStreamer(net, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        Net(make_config({**SMALL, **change, "use_attn": True,
                         "compute_dtype": "bf16"}))


def test_remat_is_accepted_and_changes_nothing():
    """`remat` only saves memory in the JAX package: the port keeps the
    field, builds the same model and ignores it."""
    on = make_config({**SMALL, "remat": True, "compute_dtype": None})
    off = make_config({**SMALL, "remat": False})
    assert on.remat and not off.remat and on.compute_dtype is None
    assert Net(on).state_dict().keys() == Net(off).state_dict().keys()


