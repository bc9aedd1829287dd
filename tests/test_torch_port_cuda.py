"""The CUDA kernels against their plain PyTorch versions, on the card: the
stack-step kernels (plain intra BLSTM and conv_lstm, rows 1-4, each without
and with the attention step, as one cluster of eight blocks a call: one
device kernel, capturable in a CUDA graph), the
slab LSTM scans (forward and backward; the fp32
forward, shared with the seq route's, at the training shapes too), the
custom-VJP route's recurrences (rows 6-9: one direction and both
directions, forward and backward, and the two autograd Functions), and the
fused inference BLSTM (row 5) with `streaming_inference_scan`'s CUDA graph.

Marked `gpu`: each test decides inside itself whether a card is present and
skips here with a reason. This file imports neither JAX nor the JAX package,
so it also runs on a machine that has only PyTorch (run it there without the
repo's conftest, which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_port_cuda.py

Tolerance 1e-4 absolute: fp32 kernel vs fp32 plain version, which differ only
in summation order over D and 2H terms (the attention steps also over the
W ring slots and the [F, e] / [F, D] LayerNorm slabs). The slab backward is held to 1e-4
of each output's peak: its weight gradients sum over all T*R rows, in
another order than the plain version's matrix products. The mixed slab
kernels (bf16 x with bf16 or fp32 weights) are held to their plain versions
as chip_smoke.py holds them: every output within 1e-2 of its peak and ys
within one bf16 ulp of its peak at all but 1e-3 of its elements (the two
round at the same points; fp32 sums in another order can move a gate across
a bf16 rounding boundary, and the recurrence carries that on). The seq
recurrences (rows 6-9) and their Functions are held to 1e-4 (fp32) and 1e-2
(mixed) of each output's peak; in the mixed mode the walks' bf16 outputs
(y, gates, dgates; the Functions' y) are also bit-equal to the plain
versions' at all but 5% of the elements, a bar that the slab's rounding
of the sigmoid fails (see chip_smoke.py's SEQ_MIXED_SHARE). The Functions'
bf16 gradients are not held to it: each rounds a sum of T*R products, and
a walk's rare one-ulp differences move 6-8% of them by one ulp. Row 5 is
held to 1e-5 max-abs (fp32, another summation order over H terms a
direction), a whole streamed net to 1e-4."""
from pathlib import Path

import numpy as np
import pytest
import torch

from sound_bubble_tpu_torch.models.tfgridnet.model import Net, NetConfig
from sound_bubble_tpu_torch.ops import rnn
from sound_bubble_tpu_torch.ops.kernels import lstm_slab as ls
from sound_bubble_tpu_torch.ops.kernels import stack_kernel as sk
from sound_bubble_tpu_torch.weights import param_tree

pytestmark = pytest.mark.gpu

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-4
# mixed slab kernels: ys within one bf16 ulp of its peak at all but this
# share of its elements (a gate moved across a bf16 rounding boundary by
# the other fp32 summation order carries on through the later frames)
MIXED_YS_FRAC = 1e-3
SIZES = {"small": dict(stft_chunk_size=16, stft_pad_size=16, D=8, H=8, B=3),
         "full": dict(stft_chunk_size=192, stft_pad_size=96, D=32, H=64,
                      B=6)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


# conv_lstm widths: the Orange Pi and Raspberry Pi models
# (`real_experiments/*.json`: F=145, D=24 / 16, B=3, H=64, s=5) and a ragged
# F (25 rows, s=4: the last row gets no up conv)
CONV_SIZES = {
    "orangepi": dict(stft_chunk_size=192, stft_pad_size=96, D=24, H=64, B=3,
                     lstm_down=5),
    "raspberrypi": dict(stft_chunk_size=192, stft_pad_size=96, D=16, H=64,
                        B=3, lstm_down=5),
    "ragged": dict(stft_chunk_size=32, stft_pad_size=16, D=8, H=8, B=3,
                   lstm_down=4)}


def _case(size, seed=0, conv=False):
    cfg = (NetConfig(conv_lstm=True, **CONV_SIZES[size]) if conv
           else NetConfig(conv_lstm=False, **SIZES[size]))
    rng = np.random.default_rng(seed)
    net = Net(cfg)
    net.load_state_dict({
        k: torch.from_numpy(np.asarray(
            rng.standard_normal(v.shape) * 0.3, np.float32))
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


@pytest.mark.parametrize("use_film", [False, True])
@pytest.mark.parametrize("size", list(CONV_SIZES))
def test_conv_kernel_matches_plain(size, use_film):
    """3 chained steps against the plain version and against
    `conv_walk_phases_ref` (the kernel's phases in its order), each with its
    own state; one launch of the conv kernel each, none of the plain stack
    kernel."""
    dev = _card()
    cfg, packed, a = _case(size, conv=True)
    packed = {k: v.to(dev) for k, v in packed.items()}
    a = {k: v.to(dev) for k, v in a.items()}
    fw = a["film_w"] if use_film else None
    fb = a["film_b"] if use_film else None
    before = (sk.gridnet_stack_step.conv_launches,
              sk.gridnet_stack_step.launches)
    hk, ck = a["h0"], a["c0"]
    refs = {fn: (hk, ck) for fn in (sk.gridnet_stack_step_ref,
                                    sk.conv_walk_phases_ref)}
    for step in range(3):
        x = a["x"] * (1.0 + 0.5 * step)
        xk, hk, ck = sk.gridnet_stack_step(packed, x, hk, ck, fw, fb,
                                           eps=cfg.eps)
        torch.cuda.synchronize()
        for fn, (hr, cr) in refs.items():
            xr, hr, cr = fn(packed, x, hr, cr, fw, fb, eps=cfg.eps)
            refs[fn] = hr, cr
            for g, w, name in ((xk, xr, "x"), (hk, hr, "h0"),
                               (ck, cr, "c0")):
                assert g.shape == w.shape, name
                err = float((g - w).abs().max())
                assert err <= TOL, f"{fn.__name__} step {step} {name}: {err}"
    assert (sk.gridnet_stack_step.conv_launches,
            sk.gridnet_stack_step.launches) == (before[0] + 3, before[1])


def test_conv_kernel_rejects_bad_operands():
    dev = _card()
    _, packed, a = _case("ragged", conv=True)
    packed = {k: v.to(dev) for k, v in packed.items()}
    x, h0, c0 = (a[k].to(dev) for k in ("x", "h0", "c0"))
    with pytest.raises(NotImplementedError, match="bfloat16"):
        sk.gridnet_stack_step(packed, x.bfloat16(), h0, c0)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        sk.gridnet_stack_step({**packed, "up_flat":
                               packed["up_flat"].bfloat16()}, x, h0, c0)
    with pytest.raises(ValueError, match="down_cat: shape"):
        sk.gridnet_stack_step({**packed, "down_cat": packed["down_cat"]
                               [..., :-1].contiguous()}, x, h0, c0)
    with pytest.raises(ValueError, match="no conv frame"):
        sk.gridnet_stack_step(packed, x[:3].contiguous(), h0[:, :3]
                              .contiguous(), c0[:, :3].contiguous())


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


# ---- rows 1-4 (`csrc/stack_walk.cu`): the stack steps, one cluster of
# eight blocks a call

# F ragged against the walk's 8-frame slabs and the cluster's row tiles:
# 17 (small), 145 (full); 9, where blocks 5-7 of the cluster own no row; B =
# 1, as FusedStreamer's per-block route calls the kernel
WALK_SIZES = {**SIZES,
              "f9": dict(stft_chunk_size=8, stft_pad_size=8, D=8, H=8, B=2),
              "block1": dict(stft_chunk_size=192, stft_pad_size=96, D=32,
                             H=64, B=1)}


def _walk_case(widths, dev, seed=0, use_attn=False):
    """(cfg, packed, packed_attn or None, draw) on the card for a seeded
    net: the model's initial distribution with every leaf moved by 0.05
    N(0, 1), as the attention tests draw theirs."""
    cfg = NetConfig(**{"conv_lstm": False, **widths}, use_attn=use_attn)
    rng = np.random.default_rng(seed)
    net = Net(cfg).init_weights(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for p in net.parameters():
            p.add_(torch.from_numpy(np.asarray(
                rng.standard_normal(tuple(p.shape)) * 0.05, np.float32)))
    tree = param_tree(net)
    packed = {k: v.to(dev) for k, v in sk.pack_stack_params(
        cfg, tree).items()}
    pa = None
    if use_attn:
        pa = {k: v.to(dev) for k, v in sk.pack_attn_params(
            cfg, tree).items()}

    def draw(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    return cfg, packed, pa, draw


@pytest.mark.parametrize("use_film", [True, False])
@pytest.mark.parametrize("size", list(WALK_SIZES))
def test_walk_kernel_matches_plain_chained(size, use_film):
    """5 chained steps (x new a step; h0, c0 carried): x, h0, c0 against
    the plain version; one launch of row 1's kernel a call, none of the
    others."""
    dev = _card()
    cfg, packed, _, draw = _walk_case(WALK_SIZES[size], dev)
    F, D, H, B = cfg.n_freqs, cfg.D, cfg.H, cfg.B
    fw, fb = ((draw(B - 1, F, D), draw(B - 1, F, D)) if use_film
              else (None, None))
    hk, ck = draw(B, F, H) * 0.5, draw(B, F, H) * 0.5
    hr, cr = hk, ck
    names = ("launches", "conv_launches", "attn_launches",
             "conv_attn_launches")
    before = {n: getattr(sk.gridnet_stack_step, n) for n in names}
    for step in range(5):
        x = draw(F, D)
        xk, hk, ck = sk.gridnet_stack_step(packed, x, hk, ck, fw, fb,
                                           eps=cfg.eps)
        torch.cuda.synchronize()
        xr, hr, cr = sk.gridnet_stack_step_ref(packed, x, hr, cr, fw, fb,
                                               eps=cfg.eps)
        for g, w, name in ((xk, xr, "x"), (hk, hr, "h0"), (ck, cr, "c0")):
            assert g.shape == w.shape, name
            err = float((g - w).abs().max())
            assert err <= TOL, f"step {step} {name}: {err}"
    grew = {n: getattr(sk.gridnet_stack_step, n) - before[n] for n in names}
    assert grew == {n: 5 if n == "launches" else 0 for n in names}


# the stack steps the walk tests call (`_walk_step`): row 1 at the
# flagship's widths, row 3 at the attention flagship's (W cut to 7), rows 2
# and 4 at the Orange Pi's (the conv_lstm pack, s = 5; W cut to 7)
WALK_ROWS = {
    1: dict(SIZES["full"]),
    3: dict(SIZES["full"], L=4, E=2, local_atten_len=7),
    2: dict(CONV_SIZES["orangepi"], conv_lstm=True),
    4: dict(CONV_SIZES["orangepi"], conv_lstm=True, L=4, E=2,
            local_atten_len=7)}


def _walk_step(row, dev):
    """A call of row 1-4's wrapper (`WALK_ROWS`) on seeded operands with
    FiLM, as a function of no arguments; its counter's name."""
    attn = row in (3, 4)
    cfg, packed, pa, draw = _walk_case(WALK_ROWS[row], dev, use_attn=attn)
    F, D, H, B = cfg.n_freqs, cfg.D, cfg.H, cfg.B
    x, h0, c0 = draw(F, D), draw(B, F, H) * 0.5, draw(B, F, H) * 0.5
    fw, fb = draw(B - 1, F, D), draw(B - 1, F, D)
    counter = ("conv_" if cfg.conv_lstm else "") + (
        "attn_launches" if attn else "launches")
    if not attn:
        return (lambda: sk.gridnet_stack_step(
            packed, x, h0, c0, fw, fb, eps=cfg.eps)), counter
    W = cfg.local_atten_len
    kr = draw(B, cfg.L * cfg.E, W, F)
    vr = draw(B, D, W, F)
    pos = torch.tensor([3], dtype=torch.int32, device=dev)
    return (lambda: sk.gridnet_stack_step_attn(
        packed, pa, x, h0, c0, kr, vr, pos, cfg.L, fw, fb,
        eps=cfg.eps)), counter


@pytest.mark.parametrize("conv", [False, True])
def test_walk_refuses_other_widths(conv):
    """H = 48 raises on the card for a plain and a conv_lstm pack (the walk
    takes H in 8, 16, 32, 64; ROADMAP Queue 2 item 10) and never runs the
    plain version."""
    dev = _card()
    widths = ({**CONV_SIZES["ragged"], "conv_lstm": True} if conv
              else SIZES["small"])
    cfg, packed, _, draw = _walk_case({**widths, "H": 48}, dev)
    F, D, H, B = cfg.n_freqs, cfg.D, cfg.H, cfg.B
    with pytest.raises(ValueError, match="Queue 2 item 10"):
        sk.gridnet_stack_step(packed, draw(F, D), draw(B, F, H),
                              draw(B, F, H))


def test_walk_plan_agrees_with_the_library():
    """`walk_plan`'s and `conv_walk_plan`'s shared memory and scratch are
    the library's, and one cluster of each kernel fits the card, at the
    widths the repo runs (the conv_lstm pack: s given)."""
    from sound_bubble_tpu_torch.ops.kernels import _build

    _card()
    lib = _build.load_library()
    for f_len, d, h, b, attn, s in (
            (145, 32, 64, 6, None, None), (145, 32, 64, 6, (4, 2, 100), None),
            (145, 32, 64, 1, None, None), (17, 8, 8, 3, None, None),
            (25, 8, 8, 3, (2, 2, 5), None), (9, 8, 8, 2, None, None),
            (145, 24, 64, 3, None, 5), (145, 24, 64, 3, (4, 2, 100), 5),
            (145, 16, 64, 3, None, 5), (145, 24, 64, 1, None, 5),
            (25, 8, 8, 3, None, 4), (25, 8, 8, 3, (2, 2, 5), 4)):
        plan = (sk.walk_plan(f_len, d, h, b, attn) if s is None
                else sk.conv_walk_plan(f_len, d, h, b, s, attn))
        heads, e, w = attn or (0, 0, 0)
        assert lib.sbt_stack_walk_smem(f_len, d, h, s or 0, heads, e, w) == \
            plan["smem"]
        assert lib.sbt_stack_walk_scratch(b, f_len, d, h, s or 0, heads,
                                          w) == plan["scratch"]
        assert lib.sbt_stack_walk_clusters(h, int(attn is not None),
                                           int(s is not None),
                                           plan["smem"]) >= 1


# attention widths: the flagship's and the Orange Pi's (L=4, E=2, W=100) at
# the stack's full depth, and a ragged small case (W=5, F=25, conv s=4)
ATTN_SIZES = {
    "flagship": dict(stft_chunk_size=192, stft_pad_size=96, D=32, H=64, B=6,
                     conv_lstm=False),
    "orangepi": dict(stft_chunk_size=192, stft_pad_size=96, D=24, H=64, B=3,
                     conv_lstm=True, lstm_down=5),
    "small": dict(stft_chunk_size=32, stft_pad_size=16, D=8, H=8, B=3, L=2,
                  local_atten_len=5, conv_lstm=False),
    "small_conv": dict(stft_chunk_size=32, stft_pad_size=16, D=8, H=8, B=3,
                       L=2, local_atten_len=5, conv_lstm=True, lstm_down=4)}


@pytest.mark.parametrize("size", list(ATTN_SIZES))
def test_attn_kernels_match_plain(size):
    """W + 5 chained steps, so that pos wraps the ring: x, h0, c0 and both
    rings against the plain version; one launch of the attention kernel
    (conv or plain branch) a step and none of the other kernels. The
    weights are the model's initial distribution with every leaf moved by
    0.05 N(0, 1) (LayerNorm affines and PReLU slopes away from their
    constants): larger random weights make the 105-step recurrence grow its
    cell state, and the two summation orders drift apart with it."""
    dev = _card()
    cfg = NetConfig(use_attn=True, **ATTN_SIZES[size])
    rng = np.random.default_rng(0)
    net = Net(cfg).init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in net.parameters():
            p.add_(torch.from_numpy(np.asarray(
                rng.standard_normal(tuple(p.shape)) * 0.05, np.float32)))
    tree = param_tree(net)
    packed = {k: v.to(dev) for k, v in sk.pack_stack_params(
        cfg, tree).items()}
    pa = {k: v.to(dev) for k, v in sk.pack_attn_params(cfg, tree).items()}
    F, D, H, B, W = cfg.n_freqs, cfg.D, cfg.H, cfg.B, cfg.local_atten_len

    def draw(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    fw, fb = draw(B - 1, F, D), draw(B - 1, F, D)
    hk, ck = draw(B, F, H) * 0.5, draw(B, F, H) * 0.5
    kk = torch.zeros((B, cfg.L * cfg.E, W, F), device=dev)
    vk = torch.zeros((B, D, W, F), device=dev)
    hr, cr, kr, vr = hk, ck, kk.clone(), vk.clone()
    counter = "conv_attn_launches" if cfg.conv_lstm else "attn_launches"
    names = ("launches", "conv_launches", "attn_launches",
             "conv_attn_launches")
    before = {n: getattr(sk.gridnet_stack_step, n) for n in names}
    for step in range(W + 5):
        x = draw(F, D)
        xk, hk, ck, kk, vk = sk.gridnet_stack_step_attn(
            packed, pa, x, hk, ck, kk, vk,
            torch.tensor([step % W], dtype=torch.int32, device=dev), cfg.L,
            fw, fb, eps=cfg.eps)
        torch.cuda.synchronize()
        xr, hr, cr, kr, vr = sk.gridnet_stack_step_attn_ref(
            packed, pa, x, hr, cr, kr, vr, step % W, cfg.L, fw, fb,
            eps=cfg.eps)
        for g, w, name in ((xk, xr, "x"), (hk, hr, "h0"), (ck, cr, "c0"),
                           (kk, kr, "k_ring"), (vk, vr, "v_ring")):
            err = float((g - w).abs().max())
            assert err <= TOL, f"step {step} {name}: {err}"
    grew = {n: getattr(sk.gridnet_stack_step, n) - before[n] for n in names}
    assert grew == {n: W + 5 if n == counter else 0 for n in names}


def test_conv_attn_chain_matches_phases():
    """Row 4 at the Orange Pi width (W = 100) over W + 5 = 105 chained steps
    from zero rings (pos wraps), with FiLM, against `conv_walk_phases_ref`
    (the kernel's phases in its launch order, with their own state): x, h0,
    c0 and both rings within 1e-4 at every step; one launch a step. The
    weights are drawn as `test_attn_kernels_match_plain` draws them."""
    dev = _card()
    cfg, packed, pa, draw = _walk_case(
        dict(CONV_SIZES["orangepi"], conv_lstm=True, L=4, E=2,
             local_atten_len=100), dev, use_attn=True)
    F, D, H, B, W = cfg.n_freqs, cfg.D, cfg.H, cfg.B, cfg.local_atten_len
    fw, fb = draw(B - 1, F, D), draw(B - 1, F, D)
    got = [draw(B, F, H) * 0.5, draw(B, F, H) * 0.5,
           torch.zeros((B, cfg.L * cfg.E, W, F), device=dev),
           torch.zeros((B, D, W, F), device=dev)]
    want = [t.clone() for t in got]
    before = sk.gridnet_stack_step.conv_attn_launches
    with torch.no_grad():
        for step in range(W + 5):
            x = draw(F, D)
            xk, *got = sk.gridnet_stack_step_attn(
                packed, pa, x, *got,
                torch.tensor([step % W], dtype=torch.int32, device=dev),
                cfg.L, fw, fb, eps=cfg.eps)
            torch.cuda.synchronize()
            xr, *want = sk.conv_walk_phases_ref(
                packed, x, want[0], want[1], fw, fb, eps=cfg.eps,
                attn=(pa, want[2], want[3], step % W, cfg.L))
            for name, g, w in zip(("x", "h0", "c0", "k_ring", "v_ring"),
                                  [xk, *got], [xr, *want]):
                err = float((g - w).abs().max())
                assert err <= TOL, f"step {step} {name}: {err}"
    assert sk.gridnet_stack_step.conv_attn_launches == before + W + 5


def test_attn_kernel_rejects_bad_operands():
    dev = _card()
    cfg = NetConfig(use_attn=True, **ATTN_SIZES["small"])
    net = Net(cfg)
    tree = param_tree(net)
    packed = {k: v.to(dev) for k, v in sk.pack_stack_params(
        cfg, tree).items()}
    pa = {k: v.to(dev) for k, v in sk.pack_attn_params(cfg, tree).items()}
    F, D, H, B, W = cfg.n_freqs, cfg.D, cfg.H, cfg.B, cfg.local_atten_len
    x = torch.zeros((F, D), device=dev)
    h0 = torch.zeros((B, F, H), device=dev)
    kr = torch.zeros((B, cfg.L * cfg.E, W, F), device=dev)
    vr = torch.zeros((B, D, W, F), device=dev)
    pos = torch.zeros((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="k_ring: on cpu"):
        sk.gridnet_stack_step_attn(packed, pa, x, h0, h0, kr.cpu(), vr, pos,
                                   cfg.L)
    with pytest.raises(ValueError, match="v_ring: shape"):
        sk.gridnet_stack_step_attn(packed, pa, x, h0, h0, kr, vr[:, 1:], pos,
                                   cfg.L)
    # the slot: an int32 [1] tensor on the card, its value read there
    for bad, err, match in ((0, TypeError, "pos: expected"),
                            (pos.cpu(), ValueError, "pos: on cpu"),
                            (pos.long(), TypeError, "pos: dtype"),
                            (pos.expand(2), ValueError, "pos: shape")):
        with pytest.raises(err, match=match):
            sk.gridnet_stack_step_attn(packed, pa, x, h0, h0, kr, vr, bad,
                                       cfg.L)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        sk.gridnet_stack_step_attn(packed, {**pa, "o_w": pa["o_w"].bfloat16()},
                                   x, h0, h0, kr, vr, pos, cfg.L)
    with pytest.raises(ValueError, match="shared memory"):
        # [L, W] scores of 4-byte floats alone: 2 x 40000 x 4 B = 320 KB
        big = torch.zeros((B, cfg.L * cfg.E, 40000, F), device=dev)
        sk.gridnet_stack_step_attn(packed, pa, x, h0, h0, big,
                                   torch.zeros((B, D, 40000, F), device=dev),
                                   pos, cfg.L)


def test_attn_kernel_takes_the_slot_modulo_w():
    """No value of pos writes outside the rings: the kernel writes slot pos
    mod W, as the plain version does; pos = W + 3 and pos = -2 give what
    pos = 3 and pos = W - 2 give, bit for bit."""
    dev = _card()
    cfg, packed, pa, draw = _walk_case(dict(ATTN_SIZES["small"]), dev,
                                       use_attn=True)
    F, D, H, B, W = cfg.n_freqs, cfg.D, cfg.H, cfg.B, cfg.local_atten_len
    x, h0, c0 = draw(F, D), draw(B, F, H) * 0.5, draw(B, F, H) * 0.5
    kr, vr = draw(B, cfg.L * cfg.E, W, F), draw(B, D, W, F)

    def step(p):
        k, v = kr.clone(), vr.clone()
        out = sk.gridnet_stack_step_attn(
            packed, pa, x, h0, c0, k, v,
            torch.tensor([p], dtype=torch.int32, device=dev), cfg.L,
            eps=cfg.eps)
        return [t.clone() for t in out]

    for p, same in ((W + 3, 3), (-2, W - 2)):
        got, want = step(p), step(same)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (p, same)
        ref = sk.gridnet_stack_step_attn_ref(
            packed, pa, x, h0, c0, kr.clone(), vr.clone(), p, cfg.L,
            eps=cfg.eps)
        for g, w in zip(got, ref):
            assert float((g - w).abs().max()) <= TOL, p


# (T, R, C, H): ragged T (K = 8 does not divide it) and R (not a multiple of
# the row tile, 8); T < K; the training widths; a narrow C and H
SLAB_SHAPES = {"ragged": (13, 37, 32, 64), "short": (5, 9, 32, 64),
               "even": (16, 16, 32, 64), "narrow": (11, 5, 8, 8)}


def _slab_case(shape, dev, seed=0):
    t_len, r, c, h = shape
    rng = np.random.default_rng(seed)

    def draw(*s, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(s) * scale).astype(np.float32)).to(dev)

    return dict(w_ih=draw(c, 4 * h, scale=0.3), w_hh=draw(h, 4 * h, scale=0.3),
                b=draw(4 * h, scale=0.1), x=draw(t_len, r, c),
                h0=draw(r, h, scale=0.5), c0=draw(r, h, scale=0.5),
                dy=draw(t_len, r, h), dhT=draw(r, h), dcT=draw(r, h))


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", list(SLAB_SHAPES))
def test_slab_kernels_match_plain(shape, reverse):
    dev = _card()
    a = _slab_case(SLAB_SHAPES[shape], dev)
    args = (a["w_ih"], a["w_hh"], a["b"], a["x"], a["h0"], a["c0"], reverse)
    f0, b0 = ls.lstm_slab_fwd.launches, ls.lstm_slab_bwd.launches
    got = ls.lstm_slab_fwd(*args)
    torch.cuda.synchronize()
    want = ls.lstm_slab_fwd_ref(*args)
    for g, w, name in zip(got, want, ("ys", "hT", "cT", "c_ckpt")):
        assert g.shape == w.shape, name
        assert float((g - w).abs().max()) <= TOL, name
    hp = ls.shift_prev(want[0], a["h0"], reverse)
    bargs = (a["w_ih"], a["w_hh"], a["b"], a["x"], hp, want[3], a["dy"],
             a["dhT"], a["dcT"], reverse)
    got_b = ls.lstm_slab_bwd(*bargs)
    torch.cuda.synchronize()
    want_b = ls.lstm_slab_bwd_ref(*bargs)
    for g, w, name in zip(got_b, want_b,
                          ("dx", "dw_ih", "dw_hh", "db", "dh0", "dc0")):
        assert g.shape == w.shape, name
        assert _rel(g, w) <= TOL, (name, _rel(g, w))
    assert ls.lstm_slab_fwd.launches == f0 + 1
    assert ls.lstm_slab_bwd.launches == b0 + 1


# the mixed forward (row 10b, the walk's mixed mode) also at 19 rows a block
# (the bf16 recipe's intra R = 2504 in one wave of 132 SMs), the edge
# widths C = 24, 16 and C = H = 8
MIXED_SLAB_SHAPES = {**{k: SLAB_SHAPES[k] for k in ("ragged", "short",
                                                    "even", "narrow")},
                     "rows19": (9, 2504, 32, 64), "c24": (11, 37, 24, 64),
                     "c16": (11, 37, 16, 64)}


@pytest.mark.parametrize("wdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", list(MIXED_SLAB_SHAPES))
def test_mixed_slab_kernels_match_plain(shape, reverse, wdt):
    dev = _card()
    a = _slab_case(MIXED_SLAB_SHAPES[shape], dev)
    if shape == "rows19":
        code = ls.DTYPES.index((torch.bfloat16, wdt))
        assert ls.fwd_row_tiles(2504, 32, 64, 132, code=code) == (19, 132)
    a["x"], a["dy"] = a["x"].bfloat16(), a["dy"].bfloat16()
    for k in ("w_ih", "w_hh", "b"):
        a[k] = a[k].to(wdt)
    args = (a["w_ih"], a["w_hh"], a["b"], a["x"], a["h0"], a["c0"], reverse)
    counts = (ls.lstm_slab_fwd.launches, ls.lstm_slab_bwd.launches,
              ls.lstm_slab_fwd.mixed_launches, ls.lstm_slab_bwd.mixed_launches)
    got = ls.lstm_slab_fwd(*args)
    torch.cuda.synchronize()
    want = ls.lstm_slab_fwd_ref(*args)
    assert got[0].dtype == torch.bfloat16
    peak = float(want[0].float().abs().max())
    ulp = 2.0 ** (np.floor(np.log2(peak)) - 7)
    err = (got[0].float() - want[0].float()).abs()
    frac = float((err > ulp).float().mean())
    assert frac <= MIXED_YS_FRAC, (frac, float(err.max()), ulp)
    for g, w, name in zip(got, want, ("ys", "hT", "cT", "c_ckpt")):
        assert g.dtype == w.dtype, name
        assert _rel(g.float(), w.float()) <= 1e-2, name
    hp = ls.shift_prev(want[0], a["h0"], reverse, wdt)
    bargs = (a["w_ih"], a["w_hh"], a["b"], a["x"], hp, want[3], a["dy"],
             a["dhT"], a["dcT"], reverse)
    got_b = ls.lstm_slab_bwd(*bargs)
    torch.cuda.synchronize()
    want_b = ls.lstm_slab_bwd_ref(*bargs)
    assert got_b[0].dtype == torch.bfloat16
    for g, w, name in zip(got_b, want_b,
                          ("dx", "dw_ih", "dw_hh", "db", "dh0", "dc0")):
        assert g.shape == w.shape, name
        assert _rel(g.float(), w.float()) <= 1e-2, (name, _rel(g.float(),
                                                               w.float()))
    assert (ls.lstm_slab_fwd.launches, ls.lstm_slab_bwd.launches,
            ls.lstm_slab_fwd.mixed_launches,
            ls.lstm_slab_bwd.mixed_launches) == (
        counts[0], counts[1], counts[2] + 1, counts[3] + 1)


def test_bf16_lstm_on_card_goes_through_the_mixed_kernels():
    """A bf16 scan launches the mixed kernels, never the fp32 ones; the
    grads come back in each input's dtype."""
    dev = _card()
    a = _slab_case(SLAB_SHAPES["ragged"], dev)
    p = {k: a[k].bfloat16().requires_grad_() for k in ("w_ih", "w_hh", "b")}
    x = a["x"].permute(1, 0, 2).contiguous().bfloat16().requires_grad_()
    counts = (ls.lstm_slab_fwd.launches, ls.lstm_slab_bwd.launches,
              ls.lstm_slab_fwd.mixed_launches, ls.lstm_slab_bwd.mixed_launches)
    y, _ = rnn.lstm(p, x)
    assert y.dtype == torch.bfloat16
    y.float().square().sum().backward()
    assert (ls.lstm_slab_fwd.launches, ls.lstm_slab_bwd.launches,
            ls.lstm_slab_fwd.mixed_launches,
            ls.lstm_slab_bwd.mixed_launches) == (
        counts[0], counts[1], counts[2] + 1, counts[3] + 1)
    assert x.grad.dtype == p["w_hh"].grad.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="bf16_gates"):
        rnn.lstm(p, x, bf16_gates=False)


def test_lstm_on_card_goes_through_the_slab_kernels():
    """ops.rnn.lstm with T >= 2 launches one forward kernel, and its
    backward one backward kernel; T == 1 launches none."""
    dev = _card()
    a = _slab_case(SLAB_SHAPES["ragged"], dev)
    p = {k: a[k].clone().requires_grad_() for k in ("w_ih", "w_hh", "b")}
    x = a["x"].permute(1, 0, 2).contiguous()          # [R, T, C]
    f0, b0 = ls.lstm_slab_fwd.launches, ls.lstm_slab_bwd.launches
    y, _ = rnn.lstm(p, x)
    y.square().sum().backward()
    assert (ls.lstm_slab_fwd.launches, ls.lstm_slab_bwd.launches) == (
        f0 + 1, b0 + 1)
    rnn.lstm(p, x[:, :1])
    assert ls.lstm_slab_fwd.launches == f0 + 1


def test_slab_kernels_reject_bad_operands():
    dev = _card()
    a = _slab_case(SLAB_SHAPES["ragged"], dev)
    args = [a["w_ih"], a["w_hh"], a["b"], a["x"], a["h0"], a["c0"], False]
    # (x, weights) in (fp32, bf16) is not a combination the recipes give
    bf = [t.bfloat16() for t in args[:3]]
    with pytest.raises(TypeError, match="slab kernels take"):
        ls.lstm_slab_fwd(*bf, *args[3:])
    # mixed weights: w_ih in bf16 beside an fp32 w_hh
    with pytest.raises(TypeError, match="w_ih: dtype"):
        ls.lstm_slab_fwd(a["w_ih"].bfloat16(), *args[1:3],
                         a["x"].bfloat16(), *args[4:])
    with pytest.raises(TypeError, match="h0: dtype"):
        ls.lstm_slab_fwd(*args[:3], a["x"].bfloat16(), a["h0"].bfloat16(),
                         *args[5:])
    with pytest.raises(TypeError, match="slab kernels take"):
        ls.lstm_slab_fwd(*args[:3], a["x"].double(), *args[4:])
    with pytest.raises(ValueError, match="w_hh: on cpu"):
        ls.lstm_slab_fwd(args[0], a["w_hh"].cpu(), *args[2:])
    with pytest.raises(ValueError, match="h0: shape"):
        ls.lstm_slab_fwd(*args[:4], a["h0"][:-1], *args[5:])
    with pytest.raises(ValueError, match="not contiguous"):
        ls.lstm_slab_fwd(*args[:3], a["x"].transpose(0, 1).contiguous()
                         .transpose(0, 1), *args[4:])


# ---- the backward kernel of row 11 at the shapes of the training paths:
# (T, R, C): the bf16 recipe's batch-8 intra and inter scans, and R that
# leave a partial last row tile under `bwd_row_tiles` (1253 rows: tiles of
# 10 in fp32; 2509: tiles of 20 in the mixed mode)
BWD_SHAPES = {"intra8": (145, 2504, 32), "inter8": (313, 1160, 32),
              "ragged_tile": (13, 1253, 32), "ragged_tile8": (13, 2509, 32)}
BWD_PAIRS = {"fp32": (torch.float32, torch.float32),
             "bf16": (torch.bfloat16, torch.bfloat16)}


def _bwd_args(shape, pair, dev, reverse=False, seed=0):
    t_len, r, c = shape
    xdt, wdt = BWD_PAIRS[pair]
    a = _slab_case((t_len, r, c, 64), dev, seed)
    a["x"], a["dy"] = a["x"].to(xdt), a["dy"].to(xdt)
    for k in ("w_ih", "w_hh", "b"):
        a[k] = (a[k] * (64 ** -0.5 / 0.3)).to(wdt)
    with torch.no_grad():
        fwd = ls.lstm_slab_fwd(a["w_ih"], a["w_hh"], a["b"], a["x"], a["h0"],
                               a["c0"], reverse)
    hp = ls.shift_prev(fwd[0], a["h0"], reverse, wdt)
    return (a["w_ih"], a["w_hh"], a["b"], a["x"], hp, fwd[3], a["dy"],
            a["dhT"], a["dcT"], reverse)


@pytest.mark.parametrize("pair", list(BWD_PAIRS))
@pytest.mark.parametrize("shape", list(BWD_SHAPES))
def test_slab_bwd_matches_plain_at_training_shapes(shape, pair):
    """The backward kernel against its plain version: each output within
    1e-4 (fp32) or 1e-2 (mixed) of its peak, as chip_smoke.py holds it."""
    dev = _card()
    bargs = _bwd_args(BWD_SHAPES[shape], pair, dev,
                      reverse=shape == "intra8")
    rows, blocks = ls.bwd_row_tiles(bargs[3].shape[1], bargs[3].shape[2], 64,
                                    ls.DTYPES.index(BWD_PAIRS[pair]),
                                    ls._n_sm(dev))
    if shape.startswith("ragged"):
        assert bargs[3].shape[1] % rows, (rows, blocks)
    with torch.no_grad():
        got = ls.lstm_slab_bwd(*bargs)
        torch.cuda.synchronize()
        want = ls.lstm_slab_bwd_ref(*bargs)
    tol = TOL if pair == "fp32" else 1e-2
    for g, w, name in zip(got, want,
                          ("dx", "dw_ih", "dw_hh", "db", "dh0", "dc0")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _rel(g.float(), w.float()) <= tol, (name, _rel(g.float(),
                                                               w.float()))


@pytest.mark.parametrize("pair", list(BWD_PAIRS))
def test_slab_bwd_is_deterministic_and_counts_one_launch(pair):
    """Two launches on the same inputs give bit-equal outputs (fixed-order
    sums, no atomics), and each call counts one launch of its
    instantiation."""
    dev = _card()
    bargs = _bwd_args(BWD_SHAPES["ragged_tile8"], pair, dev, reverse=True)
    counts = (ls.lstm_slab_bwd.launches, ls.lstm_slab_bwd.mixed_launches)
    with torch.no_grad():
        first = ls.lstm_slab_bwd(*bargs)
        second = ls.lstm_slab_bwd(*bargs)
    torch.cuda.synchronize()
    for g1, g2 in zip(first, second):
        assert torch.equal(g1, g2)
    grew = (ls.lstm_slab_bwd.launches - counts[0],
            ls.lstm_slab_bwd.mixed_launches - counts[1])
    assert grew == ((2, 0) if pair == "fp32" else (0, 2))


def test_slab_bwd_layout_and_limits_agree_with_the_library():
    """The wrapper's shared-memory formula is the library's, and the
    backward refuses what its kernel does not take."""
    from sound_bubble_tpu_torch.ops.kernels import _build

    dev = _card()
    lib = _build.load_library()
    for c, h in ((32, 64), (24, 64), (16, 64), (8, 8)):
        for code in range(3):
            for rows in (1, 5, 10, 19, 24):
                assert lib.sbt_lstm_slab_bwd_smem(c, h, rows, code) == \
                    ls.bwd_smem(c, h, rows, code)
    a = _slab_case((5, 9, 40, 64), dev)
    hp = a["x"].new_zeros(5, 9, 64)
    args = (a["w_ih"], a["w_hh"], a["b"], a["x"], hp, a["x"].new_zeros(1, 9, 64),
            a["dy"], a["dhT"], a["dcT"], False)
    with pytest.raises(ValueError, match="dW"):
        ls.lstm_slab_bwd(*args)
    a = _slab_case((5, 9, 32, 48), dev)
    with pytest.raises(ValueError, match="H=48"):
        ls.lstm_slab_bwd(a["w_ih"], a["w_hh"], a["b"], a["x"],
                         a["x"].new_zeros(5, 9, 48), a["x"].new_zeros(1, 9, 48),
                         a["dy"], a["dhT"], a["dcT"], False)


# ---- the fp32 forwards of rows 6a and 10a (csrc/lstm_fwd32.cuh's walk):
# (T, R, C) at H = 64: the flagship's training shapes, the edge widths
# (C = 24, 16), the ragged R = 37 with T = 13 (not a multiple of K = 8),
# T = 1, and R that give 3 and 7 rows a block on 132 SMs (a four-row group
# with a padding row)
FWD32_SHAPES = {"intra": (145, 1252, 32), "inter": (313, 580, 32),
                "edge_intra": (29, 1252, 24), "rpi_intra": (29, 1252, 16),
                "ragged": (13, 37, 32), "one": (1, 9, 32),
                "rows3": (11, 300, 32), "rows7": (9, 800, 24)}


@pytest.mark.parametrize("shape", list(FWD32_SHAPES))
def test_fp32_forwards_match_plain(shape):
    """Both fp32 forwards against their plain versions, the slab's in both
    directions: every output within 1e-4 max-abs; each call counts one
    launch."""
    from sound_bubble_tpu_torch.ops.kernels import lstm_train_kernel as lk

    dev = _card()
    t_len, r, c = FWD32_SHAPES[shape]
    a = _slab_case((t_len, r, c, 64), dev)
    args = tuple(a[k] * (64 ** -0.5 / 0.3) for k in ("w_ih", "w_hh", "b")) \
        + (a["x"], a["h0"], a["c0"])
    counts = (ls.lstm_slab_fwd.launches, lk.lstm_seq_fwd.launches)
    with torch.no_grad():
        for reverse in (False, True):
            got = ls.lstm_slab_fwd(*args, reverse)
            torch.cuda.synchronize()
            want = ls.lstm_slab_fwd_ref(*args, reverse)
            for g, w, name in zip(got, want, ("ys", "hT", "cT", "c_ckpt")):
                assert g.shape == w.shape, name
                assert float((g - w).abs().max()) <= TOL, (name, reverse)
        got = lk.lstm_seq_fwd(*args)
        torch.cuda.synchronize()
        want = lk.lstm_seq_fwd_ref(*args)
    for g, w, name in zip(got, want, ("y", "gates", "c")):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert float((g - w).abs().max()) <= TOL, name
    assert (ls.lstm_slab_fwd.launches - counts[0],
            lk.lstm_seq_fwd.launches - counts[1]) == (2, 1)


def test_fp32_forward_layout_and_limits_agree_with_the_library():
    """The wrapper's shared-memory formula is the library's, the row tiles
    fit one wave of this card's SMs at the training shapes, and both fp32
    forwards refuse (ValueError, no launch) an H, a C or an x alignment
    their kernel does not take."""
    from sound_bubble_tpu_torch.ops.kernels import _build
    from sound_bubble_tpu_torch.ops.kernels import lstm_train_kernel as lk

    dev = _card()
    lib = _build.load_library()
    for c, h in ((32, 64), (24, 64), (16, 64), (8, 8), (4, 16), (64, 32)):
        for rows in (1, 5, 10, 19, 24):
            assert lib.sbt_lstm_fwd32_smem(c, h, rows) == \
                ls.fwd_smem(c, h, rows)
    for c, h, rows in ((32, 48, 1), (30, 64, 1), (32, 64, 25)):
        assert lib.sbt_lstm_fwd32_smem(c, h, rows) == 0
    n_sm = ls._n_sm(dev)
    for r in (580, 1252):
        rows, blocks = ls.fwd_row_tiles(r, 32, 64, n_sm)
        assert blocks <= n_sm and rows == -(-r // n_sm)
    before = (ls.lstm_slab_fwd.launches, lk.lstm_seq_fwd.launches)
    for (t_len, r, c, h), match in (((5, 9, 32, 48), "H=48"),
                                    ((5, 9, 30, 64), "C=30")):
        a = _slab_case((t_len, r, c, h), dev)
        args = (a["w_ih"], a["w_hh"], a["b"], a["x"], a["h0"], a["c0"])
        with pytest.raises(ValueError, match=match):
            ls.lstm_slab_fwd(*args, False)
        with pytest.raises(ValueError, match=match):
            lk.lstm_seq_fwd(*args)
    a = _slab_case((5, 9, 32, 64), dev)
    x = torch.empty(a["x"].numel() + 1, device=dev)[1:].view(5, 9, 32)
    x.copy_(a["x"])
    args = (a["w_ih"], a["w_hh"], a["b"], x, a["h0"], a["c0"])
    with pytest.raises(ValueError, match="aligned"):
        ls.lstm_slab_fwd(*args, True)
    with pytest.raises(ValueError, match="aligned"):
        lk.lstm_seq_fwd(*args)
    assert (ls.lstm_slab_fwd.launches, lk.lstm_seq_fwd.launches) == before


# ---- the custom-VJP kernel route (ops/kernels/lstm_train_kernel.py):
# (T, R, C, H) with R ragged against the row tile (8), T = 1, the training
# widths and a narrow C and H; the three (x, weights) pairs
SEQ_SHAPES = {"ragged": (13, 37, 32, 64), "one": (1, 9, 32, 64),
              "narrow": (11, 5, 8, 8), "wide": (9, 2504, 32, 64),
              "c24": (13, 37, 24, 64), "c16": (13, 37, 16, 64)}
SEQ_PAIRS = {"fp32": (torch.float32, torch.float32),
             "bf16": (torch.bfloat16, torch.bfloat16),
             "bf16_fp32w": (torch.bfloat16, torch.float32)}


def _seq_case(shape, dev, pair, seed=0):
    a = _slab_case(shape, dev, seed)
    xdt, wdt = SEQ_PAIRS[pair]
    b = _slab_case(shape, dev, seed + 1)
    a.update(w_ih_b=b["w_ih"], w_hh_b=b["w_hh"], b_b=b["b"],
             dy2=torch.cat([a["dy"], b["dy"]], dim=-1))
    for k in ("x", "dy", "dy2"):
        a[k] = a[k].to(xdt)
    for k in ("w_ih", "w_hh", "b", "w_ih_b", "w_hh_b", "b_b"):
        a[k] = a[k].to(wdt)
    return a


def _seq_counts(lk):
    return [(f.launches, f.mixed_launches) for f in
            (lk.lstm_seq_fwd, lk.lstm_seq_bwd, lk.blstm_seq_fwd,
             lk.blstm_seq_bwd)]


# mixed seq kernels: the share of bf16 elements that may differ from the
# plain version's
SEQ_MIXED_SHARE = 0.05


def _close(got, want, name, tol, walk=True):
    """got within tol of want's peak; a bf16 output of a walk (`walk`: y,
    gates, dgates, not the gradients' products, which round sums of T*R
    terms) also bit-equal at all but SEQ_MIXED_SHARE of its elements."""
    assert got.shape == want.shape and got.dtype == want.dtype, name
    err = _rel(got.float(), want.float())
    print(f"{name}: max-abs / peak {err:.4e}")     # shown with -rP
    assert err <= tol, (name, err)
    if walk and got.dtype == torch.bfloat16:
        share = float((got.cpu() != want.cpu()).float().mean())
        print(f"{name}: bf16 elements differing {share:.4%}")
        assert share <= SEQ_MIXED_SHARE, (name, share)


@pytest.mark.parametrize("row", ["row6", "row7", "row8", "row9"])
@pytest.mark.parametrize("pair", list(SEQ_PAIRS))
@pytest.mark.parametrize("shape", list(SEQ_SHAPES))
def test_seq_kernels_match_plain(shape, pair, row):
    """Rows 6-9 against their plain versions, a case a row (so that one
    row's failure hides no other: rows 7 and 9 run on the plain forwards'
    gates and c): fp32 within 1e-4 of each output's peak, mixed within 1e-2
    (the slab's mixed bar) and bf16 outputs bit-equal at all but
    SEQ_MIXED_SHARE of the elements. Only the row's own kernel launches."""
    from sound_bubble_tpu_torch.ops.kernels import lstm_train_kernel as lk

    dev = _card()
    a = _seq_case(SEQ_SHAPES[shape], dev, pair)
    tol = TOL if pair == "fp32" else 1e-2
    code = ls.DTYPES.index(SEQ_PAIRS[pair])
    if shape == "wide":                      # the walks' one wave
        if row == "row6" and pair != "fp32":
            assert ls.fwd_row_tiles(2504, 32, 64, 132, 1, code,
                                    bseq=True) == (19, 132)
        if row == "row8" and pair != "fp32":
            assert ls.fwd_row_tiles(2504, 32, 64, 132, 2, code,
                                    bseq=True) == (38, 132)
        if row == "row7":
            assert lk.seq_bwd_row_tiles(2504, 64, code, 132, 1) == (19, 132)
        if row == "row9":
            assert lk.seq_bwd_row_tiles(2504, 64, code, 132) == (38, 132)
    before = _seq_counts(lk)
    if row in ("row6", "row7"):
        fargs = (a["w_ih"], a["w_hh"], a["b"], a["x"], a["h0"], a["c0"])
        want = lk.lstm_seq_fwd_ref(*fargs)
        if row == "row6":
            got = lk.lstm_seq_fwd(*fargs)
            names = ("y", "gates", "c")
        else:
            bargs = (want[1], want[2], a["c0"], a["dy"], a["dhT"], a["dcT"],
                     a["w_hh"], a["x"].dtype)
            got = lk.lstm_seq_bwd(*bargs)
            want = lk.lstm_seq_bwd_ref(*bargs)
            names = ("dgates", "dh0", "dc0")
    else:
        pack = lk._blstm_pack(
            {"w_ih": a["w_ih"], "w_hh": a["w_hh"], "b": a["b"]},
            {"w_ih": a["w_ih_b"], "w_hh": a["w_hh_b"], "b": a["b_b"]})
        want = lk.blstm_seq_fwd_ref(*pack, a["x"])
        if row == "row8":
            got = lk.blstm_seq_fwd(*pack, a["x"])
            names = ("y", "gates", "c")
        else:
            bargs = (pack[2], want[1], want[2], a["dy2"], a["x"].dtype)
            got = (lk.blstm_seq_bwd(*bargs),)
            want = (lk.blstm_seq_bwd_ref(*bargs),)
            names = ("dgates",)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, names):
        _close(g, w, f"{row} {name}", tol)
    k = 1 if pair != "fp32" else 0
    grew = [tuple(n - m for n, m in zip(x, y))
            for x, y in zip(_seq_counts(lk), before)]
    want_grew = [(0, 0)] * 4
    want_grew[int(row[-1]) - 6] = (1 - k, k)
    assert grew == want_grew, grew


@pytest.mark.parametrize("pair", list(SEQ_PAIRS))
def test_seq_functions_match_plain(pair):
    """The two autograd Functions on the card (the kernels) against the same
    Functions on the CPU (the plain versions): outputs and every gradient
    (dW_ih, dW_hh, db, dx, dh0, dc0)."""
    from sound_bubble_tpu_torch.ops.kernels import lstm_train_kernel as lk

    dev = _card()
    a = _seq_case(SEQ_SHAPES["ragged"], dev, pair)
    tol = TOL if pair == "fp32" else 1e-2
    rng = np.random.default_rng(5)
    t_len, r, _, h = SEQ_SHAPES["ragged"]
    weights = [rng.standard_normal(s).astype(np.float32) for s in
               ((t_len, r, h), (r, h), (r, h), (t_len, r, 2 * h))]
    results = []
    for where in (dev, torch.device("cpu")):
        t = {k: v.to(where).clone().requires_grad_(v.is_floating_point())
             for k, v in a.items()}
        y, hT, cT = lk.lstm_seq(t["w_ih"], t["w_hh"], t["b"], t["x"],
                                t["h0"], t["c0"])
        yb = lk.blstm_seq({"w_ih": t["w_ih"], "w_hh": t["w_hh"],
                           "b": t["b"]},
                          {"w_ih": t["w_ih_b"], "w_hh": t["w_hh_b"],
                           "b": t["b_b"]}, t["x"])
        loss = sum((v.float() * torch.from_numpy(w).to(where)).sum()
                   for v, w in zip((y, hT, cT, yb), weights))
        loss.backward()
        names = ("w_ih", "w_hh", "b", "x", "h0", "c0", "w_ih_b", "w_hh_b",
                 "b_b")
        results.append(([v.detach().cpu() for v in (y, hT, cT, yb)],
                         [t[k].grad.cpu() for k in names]))
    (got_o, got_g), (want_o, want_g) = results
    for g, w, name in zip(got_o, want_o, ("y", "hT", "cT", "y_blstm")):
        _close(g, w, name, tol)
    for g, w, name in zip(got_g, want_g, ("dw_ih", "dw_hh", "db", "dx",
                                          "dh0", "dc0", "dw_ih_b",
                                          "dw_hh_b", "db_b")):
        _close(g, w, name, tol, walk=False)


def test_seq_route_on_card_goes_through_the_seq_kernels():
    """ops.rnn on scan="seq": lstm launches rows 6 and 7 once each, blstm
    rows 8 and 9, and no slab kernel; T == 1 of lstm launches nothing."""
    from sound_bubble_tpu_torch.ops.kernels import lstm_train_kernel as lk

    dev = _card()
    a = _seq_case(SEQ_SHAPES["ragged"], dev, "fp32")
    p = {k: a[k].clone().requires_grad_() for k in ("w_ih", "w_hh", "b")}
    x = a["x"].permute(1, 0, 2).contiguous()          # [R, T, C]
    before, slab = _seq_counts(lk), (ls.lstm_slab_fwd.launches,
                                     ls.lstm_slab_bwd.launches)
    y, _ = rnn.lstm(p, x, scan="seq")
    yb = rnn.blstm({"fwd": p, "bwd": p}, x, scan="seq")
    (y.square().sum() + yb.square().sum()).backward()
    rnn.lstm(p, x[:, :1], scan="seq")
    grew = [tuple(n - m for n, m in zip(u, v))
            for u, v in zip(_seq_counts(lk), before)]
    assert grew == [(1, 0)] * 4, grew
    assert (ls.lstm_slab_fwd.launches, ls.lstm_slab_bwd.launches) == slab
    with pytest.raises(NotImplementedError, match="reverse"):
        rnn.lstm(p, x, reverse=True, scan="seq")


def test_mixed_forward_layout_and_limits_agree_with_the_library():
    """The mixed forwards' (rows 10b, 8b and 6b; 6b takes 8b's layout)
    shared-memory formula is the library's for both pairs and both layouts,
    and all three refuse (ValueError, no launch) an H, a C or a C past the
    tensor cores' projection that the walk does not take."""
    from sound_bubble_tpu_torch.ops.kernels import _build
    from sound_bubble_tpu_torch.ops.kernels import lstm_train_kernel as lk

    dev = _card()
    lib = _build.load_library()
    for c, h in ((32, 64), (24, 64), (16, 64), (8, 8), (64, 32)):
        for code in (1, 2):
            for bseq in (0, 1):
                for rows in (1, 9, 19, 38, 48):
                    assert lib.sbt_lstm_fwd_mixed_smem(
                        c, h, rows, code, bseq) == ls.fwd_smem(
                            c, h, rows, code, bool(bseq))
    for c, h, rows, code in ((32, 48, 1, 1), (12, 64, 1, 2), (72, 64, 1, 1),
                             (32, 64, 49, 2), (32, 64, 1, 0)):
        assert lib.sbt_lstm_fwd_mixed_smem(c, h, rows, code, 0) == 0
    before = _seq_counts(lk) + [(ls.lstm_slab_fwd.launches,
                                 ls.lstm_slab_fwd.mixed_launches)]
    for shape, wdt, match in (((5, 9, 32, 48), torch.bfloat16, "H=48"),
                              ((5, 9, 12, 64), torch.float32, "C=12"),
                              ((5, 9, 72, 64), torch.bfloat16, "C=72")):
        a = _slab_case(shape, dev)
        w = [a[k].to(wdt) for k in ("w_ih", "w_hh", "b")]
        x = a["x"].bfloat16()
        with pytest.raises(ValueError, match=match):
            ls.lstm_slab_fwd(*w, x, a["h0"], a["c0"], False)
        p = {"w_ih": w[0], "w_hh": w[1], "b": w[2]}
        with pytest.raises(ValueError, match=match):
            lk.blstm_seq_fwd(*lk._blstm_pack(p, p), x)
        with pytest.raises(ValueError, match=match):
            lk.lstm_seq_fwd(*w, x, a["h0"], a["c0"])
    assert _seq_counts(lk) + [(ls.lstm_slab_fwd.launches,
                               ls.lstm_slab_fwd.mixed_launches)] == before


def test_blstm_bwd_layout_and_limits_agree_with_the_library():
    """The backward walk's shared-memory formula (`seq_bwd_smem`, rows 7 and
    9 alike) is the library's for the three pairs; the library refuses an H
    or a row count it does not take, and row 7's entry a missing end; row
    7's grid is one wave at the inter LSTM's R = 580 (5 rows a block) and
    R = 1160 (9); both wrappers raise (ValueError, no launch) for an H the
    walk does not take and for a dy (row 7: a c0) off 16-byte
    alignment."""
    from sound_bubble_tpu_torch.ops.kernels import _build
    from sound_bubble_tpu_torch.ops.kernels import lstm_train_kernel as lk

    dev = _card()
    lib = _build.load_library()
    for h in (8, 16, 32, 64):
        for code in (0, 1, 2):
            for rows in (1, 5, 19, 38, 48):
                assert lib.sbt_blstm_seq_bwd_smem(h, rows, code) == \
                    lk.seq_bwd_smem(h, rows, code)
    for h, rows in ((48, 1), (64, 0), (64, 49)):
        assert lib.sbt_blstm_seq_bwd_smem(h, rows, 1) == 0
    for code in (0, 1, 2):
        assert lk.seq_bwd_row_tiles(580, 64, code, 132, 1) == (5, 116)
        assert lk.seq_bwd_row_tiles(1160, 64, code, 132, 1) == (9, 129)
    before = _seq_counts(lk)
    # row 7's C entry: a null end is refused before any launch
    t_len, r, h = 5, 9, 64
    z = torch.zeros(t_len * r * 4 * h, device=dev)
    assert lib.sbt_lstm_seq_bwd(z.data_ptr(), z.data_ptr(), None,
                                z.data_ptr(), z.data_ptr(), z.data_ptr(),
                                z.data_ptr(), z.data_ptr(), z.data_ptr(),
                                z.data_ptr(), t_len, r, h, 0, 5, None) != 0
    a = _seq_case((5, 9, 32, 48), dev, "fp32")
    with pytest.raises(ValueError, match="H=48"):
        lk.lstm_seq_bwd(torch.zeros(5, 9, 192, device=dev),
                        torch.zeros(5, 9, 48, device=dev), a["c0"], a["dy"],
                        a["dhT"], a["dcT"], a["w_hh"], torch.float32)
    c0 = torch.zeros(r * h + 1, device=dev)[1:].view(r, h)
    with pytest.raises(ValueError, match="c0: not aligned"):
        lk.lstm_seq_bwd(torch.zeros(t_len, r, 4 * h, device=dev),
                        torch.zeros(t_len, r, h, device=dev), c0,
                        torch.zeros(t_len, r, h, device=dev),
                        torch.zeros(r, h, device=dev),
                        torch.zeros(r, h, device=dev),
                        torch.zeros(h, 4 * h, device=dev), torch.float32)
    a = _seq_case((5, 9, 32, 48), dev, "bf16")
    with pytest.raises(ValueError, match="H=48"):
        lk.blstm_seq_bwd(torch.zeros(96, 384, device=dev,
                                     dtype=torch.bfloat16),
                         torch.zeros(5, 9, 384, device=dev,
                                     dtype=torch.bfloat16),
                         torch.zeros(5, 9, 96, device=dev), a["dy2"],
                         torch.bfloat16)
    t_len, r, h = 5, 9, 64
    dy = torch.zeros(t_len * r * 2 * h + 1, device=dev,
                     dtype=torch.bfloat16)[1:].view(t_len, r, 2 * h)
    with pytest.raises(ValueError, match="dy: not aligned"):
        lk.blstm_seq_bwd(torch.zeros(2 * h, 8 * h, device=dev,
                                     dtype=torch.bfloat16),
                         torch.zeros(t_len, r, 8 * h, device=dev,
                                     dtype=torch.bfloat16),
                         torch.zeros(t_len, r, 2 * h, device=dev), dy,
                         torch.bfloat16)
    assert _seq_counts(lk) == before


def test_seq_kernels_reject_bad_operands():
    from sound_bubble_tpu_torch.ops.kernels import lstm_train_kernel as lk

    dev = _card()
    a = _seq_case(SEQ_SHAPES["ragged"], dev, "fp32")
    args = [a["w_ih"], a["w_hh"], a["b"], a["x"], a["h0"], a["c0"]]
    with pytest.raises(TypeError, match="seq kernels take"):
        lk.lstm_seq_fwd(*[t.bfloat16() for t in args[:3]], *args[3:])
    with pytest.raises(TypeError, match="h0: dtype"):
        lk.lstm_seq_fwd(*args[:3], a["x"].bfloat16(), a["h0"].bfloat16(),
                        a["c0"])
    with pytest.raises(ValueError, match="w_hh: on cpu"):
        lk.lstm_seq_fwd(args[0], a["w_hh"].cpu(), *args[2:])
    with pytest.raises(ValueError, match="c0: shape"):
        lk.lstm_seq_fwd(*args[:5], a["c0"][:-1])
    pack = lk._blstm_pack({"w_ih": a["w_ih"], "w_hh": a["w_hh"],
                           "b": a["b"]},
                          {"w_ih": a["w_ih"], "w_hh": a["w_hh"],
                           "b": a["b"]})
    with pytest.raises(ValueError, match="w_hh: shape"):
        lk.blstm_seq_fwd(pack[0], pack[1], a["w_hh"], pack[3], a["x"])
    y, gates, c = lk.blstm_seq_fwd(*pack, a["x"])
    with pytest.raises(ValueError, match="not contiguous"):
        lk.blstm_seq_bwd(pack[2], gates, c, a["dy2"].transpose(0, 1)
                         .contiguous().transpose(0, 1), torch.float32)


# ---- row 8a: the fp32 fused-direction forward on the walk of
# csrc/lstm_fwd32.cuh, one grid half a direction. (T, R, C) at H = 64: the
# intra training shape, the edge widths (C = 24, 16), the ragged R = 37 with
# T = 13, T = 1; rows a block with a 1-, 2- and 3-row tail (see
# `_bfwd_tail_rows`)
BFWD32_SHAPES = {"intra": (145, 1252, 32), "edge_intra": (29, 1252, 24),
                 "rpi_intra": (29, 1252, 16), "ragged": (13, 37, 32),
                 "one": (1, 9, 32)}


def _bfwd_tail_rows(tail, n_sm):
    """The least R >= 150 whose two-direction row tiles on n_sm SMs have
    rows % 4 == tail (a last row group of `tail` rows) and a last tile of
    `tail` rows."""
    for r in range(150, 2000):
        rows, _ = ls.fwd_row_tiles(r, 32, 64, n_sm, nd=2)
        if rows % 4 == tail and r % rows == tail:
            return r
    raise AssertionError(f"no R for a {tail}-row tail")


def _bfwd_check(t_len, r, c, dev, seed=0):
    """blstm_seq_fwd in fp32 against its plain version: y, gates and c
    within 1e-4 max-abs, one launch; returns the operands and outputs."""
    from sound_bubble_tpu_torch.ops.kernels import lstm_train_kernel as lk

    a = _seq_case((t_len, r, c, 64), dev, "fp32", seed)
    pack = lk._blstm_pack(
        {"w_ih": a["w_ih"], "w_hh": a["w_hh"], "b": a["b"]},
        {"w_ih": a["w_ih_b"], "w_hh": a["w_hh_b"], "b": a["b_b"]})
    before = (lk.blstm_seq_fwd.launches, lk.blstm_seq_fwd.mixed_launches)
    with torch.no_grad():
        got = lk.blstm_seq_fwd(*pack, a["x"])
        torch.cuda.synchronize()
        want = lk.blstm_seq_fwd_ref(*pack, a["x"])
    for g, w, name in zip(got, want, ("y", "gates", "c")):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert float((g - w).abs().max()) <= TOL, name
    assert (lk.blstm_seq_fwd.launches - before[0],
            lk.blstm_seq_fwd.mixed_launches - before[1]) == (1, 0)
    return a, got


@pytest.mark.parametrize("shape", list(BFWD32_SHAPES))
def test_blstm_fwd32_matches_plain(shape):
    """Row 8a in fp32 against `blstm_seq_fwd_ref` at the training shapes,
    a ragged R, T = 1; its grid is one wave of both directions' tiles at
    R = 1252."""
    dev = _card()
    t_len, r, c = BFWD32_SHAPES[shape]
    _bfwd_check(t_len, r, c, dev)
    n_sm = ls._n_sm(dev)
    if r == 1252:
        rows, blocks = ls.fwd_row_tiles(r, c, 64, n_sm, nd=2)
        assert blocks <= n_sm and blocks == 2 * -(-r // rows)


@pytest.mark.parametrize("tail", [1, 2, 3])
def test_blstm_fwd32_row_tails(tail):
    """Row 8a where a block's last row group, and the grid's last tile,
    hold 1, 2 or 3 rows."""
    dev = _card()
    _bfwd_check(9, _bfwd_tail_rows(tail, ls._n_sm(dev)), 32, dev, tail)


def test_blstm_fwd32_backward_direction_at_the_walks_step():
    """The backward direction's half of row 8a's outputs is the
    single-direction forward on the reversed input (zero states): its gates
    and c at the walk's step (gate g at columns g*2H + H ...), its y at the
    original time."""
    from sound_bubble_tpu_torch.ops.kernels import lstm_train_kernel as lk

    dev = _card()
    t_len, r, h = 13, 37, 64
    a, (y, gates, c) = _bfwd_check(t_len, r, 32, dev, 3)
    zeros = torch.zeros(r, h, device=dev)
    with torch.no_grad():
        y_b, g_b, c_b = lk.lstm_seq_fwd_ref(a["w_ih_b"], a["w_hh_b"], a["b_b"],
                                            a["x"].flip(0), zeros, zeros)
    g_half = gates.reshape(t_len, r, 4, 2, h)[:, :, :, 1]
    assert float((g_half - g_b.reshape(t_len, r, 4, h)).abs().max()) <= TOL
    assert float((c[..., h:] - c_b).abs().max()) <= TOL
    assert float((y[..., h:] - y_b.flip(0)).abs().max()) <= TOL


# ---- row 5: the fused inference BLSTM (ops/kernels/lstm_kernel.py)

# (R, T, C) at H = 64: serving one stream at the flagship's width (F = 145,
# C = 32) and four streams, one stream at the conv_lstm width (k = 29
# frames, C = 24), and the offline shape of a 2 s clip (250 frames)
ROW5_SHAPES = {"serve1": (1, 145, 32), "serve4": (4, 145, 32),
               "conv1": (1, 29, 24), "offline": (250, 145, 32)}
ROW5_TOL = 1e-5


def _row5_case(shape, dev, h=64, seed=0):
    r, t_len, c = shape
    rng = np.random.default_rng(seed)
    bound = 1 / np.sqrt(h)

    def u(*s):
        return torch.from_numpy(
            rng.uniform(-bound, bound, s).astype(np.float32)).to(dev)

    params = {d: {"w_ih": u(c, 4 * h), "w_hh": u(h, 4 * h), "b": 2 * u(4 * h)}
              for d in ("fwd", "bwd")}
    x = torch.from_numpy(rng.standard_normal((r, t_len, c))
                         .astype(np.float32)).to(dev)
    return params, x


@pytest.mark.parametrize("shape", list(ROW5_SHAPES))
def test_blstm_infer_is_one_device_kernel(shape):
    """Row 5's whole function on the card is one kernel a call, the
    projection included: torch.profiler sees no other device work (no
    product, no copy) over 5 calls. CUPTI now and then drops a record, so
    4 or 5 kernel records pass."""
    from torch.profiler import ProfilerActivity, profile

    from sound_bubble_tpu_torch.ops.kernels import lstm_kernel as rk

    dev = _card()
    params, x = _row5_case(ROW5_SHAPES[shape], dev)
    with torch.no_grad():
        rk.blstm_infer(params, x)
        torch.cuda.synchronize()
        before = rk.blstm_infer.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                rk.blstm_infer(params, x)
            torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert rk.blstm_infer.launches == before + 5
    assert 4 <= len(names) <= 5, names
    assert all("blstm_infer_kernel" in n for n in names), names


@pytest.mark.parametrize("shape", list(ROW5_SHAPES))
def test_blstm_infer_kernel_matches_plain(shape):
    from sound_bubble_tpu_torch.ops.kernels import lstm_kernel as rk

    dev = _card()
    params, x = _row5_case(ROW5_SHAPES[shape], dev)
    before = rk.blstm_infer.launches
    with torch.no_grad():
        got = rk.blstm_infer(params, x)
        want = rk.blstm_infer_ref(params, x)
    torch.cuda.synchronize()
    assert rk.blstm_infer.launches == before + 1
    assert got.shape == want.shape == x.shape[:2] + (128,)
    assert float((got - want).abs().max()) <= ROW5_TOL


def test_blstm_infer_takes_strided_and_unaligned_x():
    """x as a transposed view and at an offset that is not 16-byte aligned
    (the kernel copies x in 16-byte pieces): the wrapper gives the kernel
    an aligned contiguous copy; the same y as for contiguous x."""
    from sound_bubble_tpu_torch.ops.kernels import lstm_kernel as rk

    dev = _card()
    params, x = _row5_case((3, 29, 32), dev)
    with torch.no_grad():
        want = rk.blstm_infer(params, x)
        strided = x.transpose(0, 1).contiguous().transpose(0, 1)
        flat = torch.empty(x.numel() + 1, device=dev)
        unaligned = flat[1:].view(x.shape)
        unaligned.copy_(x)
        for got in (rk.blstm_infer(params, strided),
                    rk.blstm_infer(params, unaligned)):
            torch.cuda.synchronize()
            assert torch.equal(got, want)


def test_blstm_infer_refuses_what_the_kernel_does_not_take(monkeypatch):
    """An unbuilt width raises on the card and never runs the plain
    version; so do bf16 and a call under grad."""
    from sound_bubble_tpu_torch.ops.kernels import lstm_kernel as rk

    dev = _card()
    monkeypatch.setattr(rk, "blstm_recur_ref", None)   # must not be called
    params, x = _row5_case((2, 9, 8), dev, h=8)
    with torch.no_grad(), pytest.raises(ValueError, match="H=8"):
        rk.blstm_infer(params, x)
    params, x = _row5_case((2, 9, 8), dev)
    with pytest.raises(NotImplementedError):
        rk.blstm_infer(params, x.bfloat16())
    with pytest.raises(RuntimeError, match="no backward"):
        rk.blstm_infer(params, x.requires_grad_())


@pytest.mark.parametrize("dir_fuse", [True, False])
def test_streaming_scan_graph_matches_loop(dir_fuse):
    """streaming_inference_scan's CUDA graph against the chunk loop on a
    seeded net at the kernel's serving width (H = 64; D = 8, B = 2): the
    row-5 route (dir_fuse) and the slab route. The launch counters read as
    if the graph's launches ran eagerly: B a chunk, plus the warm-up's."""
    from sound_bubble_tpu_torch.models.tfgridnet.model import make_config
    from sound_bubble_tpu_torch.ops import kernels
    from sound_bubble_tpu_torch.runtime.streaming import (
        ModelWrapper, streaming_inference, streaming_inference_scan)

    dev = _card()
    cfg = make_config(dict(stft_chunk_size=32, stft_pad_size=16, D=8, H=64,
                           B=2))
    net = Net(cfg, pallas_blstm=dir_fuse).init_weights(
        torch.Generator().manual_seed(0)).to(dev)
    n = 12
    x = np.random.default_rng(1).standard_normal(
        (1, cfg.num_ch, 16 + 32 * n)).astype(np.float32)
    want = streaming_inference(ModelWrapper(net, device=dev), x, 32, 16)
    key = ("blstm_infer.launches" if dir_fuse else
           "lstm_slab_fwd.launches")
    before = kernels.launch_counts()[key]
    got = streaming_inference_scan(net, x, 32, 16, dir_fuse=dir_fuse,
                                   device=dev)
    torch.cuda.synchronize()
    per_chunk = cfg.B * (1 if dir_fuse else 2)
    assert kernels.launch_counts()[key] - before == per_chunk * (n + 1)
    assert got.shape == want.shape == (1, 1, 32 * n)
    assert float((got - want).abs().max()) <= TOL


# ---- rows 1 and 3 again: the profiler and a CUDA graph, last in the file.
# On the card, torch.profiler sessions in a process that has run other
# sessions and captured CUDA graphs dropped kernel records: row 5's
# profiler test above saw 2 of its 5 after these ran before it, and a row-3
# session after the graph tests saw none. So the profile is taken in a
# fresh process, and the graph test comes after every profiler session.

PROFILE_WALK = """
import json, sys
sys.path[:0] = [{repo!r}, {tests!r}]
import torch
from torch.profiler import ProfilerActivity, profile
from sound_bubble_tpu_torch.ops.kernels import _build
from sound_bubble_tpu_torch.ops.kernels import stack_kernel as sk
import test_torch_port_cuda as t
dev = torch.device("cuda")
steps = [t._walk_step(row, dev) for row in (1, 3, 2, 4)]
before = {{}}
with torch.no_grad():
    for step, counter in steps:
        step()
        before[counter] = getattr(sk.gridnet_stack_step, counter)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for step, _ in steps:
            for _ in range(5):
                step()
        torch.cuda.synchronize()
print(json.dumps({{
    "build_log": _build.build_log(),
    "launches": {{c: getattr(sk.gridnet_stack_step, c) - n
                  for c, n in before.items()}},
    "names": [e.name for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]}}))
"""


@pytest.fixture(scope="module")
def walk_profile():
    """torch.profiler's device kernel records of 5 calls of each of rows 1,
    3, 2 and 4 (`_walk_step`), in one session of a fresh process that loads
    the library this process built, without running nvcc (the same key);
    and the launch counts there."""
    import json
    import subprocess
    import sys

    from sound_bubble_tpu_torch.ops.kernels import _build

    _card()
    lib = _build.load_library()._name
    code = PROFILE_WALK.format(repo=str(REPO), tests=str(REPO / "tests"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["build_log"] == f"reused {lib.split('.')[-2]}: {lib}"
    return out


@pytest.mark.parametrize("row", list(WALK_ROWS))
def test_walk_is_one_device_kernel(row, walk_profile):
    """Rows 1-4 on the card are one kernel a call (the cluster form):
    torch.profiler sees no other device work (no product, no copy, no
    cuBLAS or cuDNN kernel) over 5 calls of each, and the wrapper counts one
    launch a call. CUPTI now and then drops a record, so 4 or 5 kernel
    records of each pass."""
    names = walk_profile["names"]
    assert all("stack_walk_kernel" in n for n in names), names
    attn, conv = (str(row in flags).lower() for flags in ((3, 4), (2, 4)))
    mine = [n for n in names
            if f"stack_walk_kernel<64, {attn}, {conv}>" in n]
    assert 4 <= len(mine) <= 5, names
    counter = ("conv_" if conv == "true" else "") + (
        "attn_launches" if attn == "true" else "launches")
    assert walk_profile["launches"][counter] == 5


@pytest.mark.parametrize("row", list(WALK_ROWS))
def test_walk_graph_replay_is_bit_equal(row):
    """One call captured in a CUDA graph and replayed gives what the eager
    call gave, bit for bit (no host sync, no allocation in the kernel, no
    atomics: its sums run in a fixed order)."""
    dev = _card()
    step, _ = _walk_step(row, dev)
    with torch.no_grad():
        eager = [t.clone() for t in step()]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = step()
        graph.replay()
        torch.cuda.synchronize()
    for got, want in zip(outs, eager):
        assert torch.equal(got, want)


# ---- the graphed streaming step (`runtime/fast_path.py`): after the
# profiler sessions above, since FusedStreamer.feed captures a CUDA graph

def test_fused_streamer_attn_routes_agree_on_card():
    """A seeded attention net at the flagship width (B cut to 2, W to 6),
    FusedStreamer on the card: the in-kernel route against the per-block
    route (row-1 kernel a block, attention in PyTorch), 8 chunks (pos
    wraps), 1e-4 of the output's peak; one attention launch a chunk on the
    first route, B launches of the plain stack kernel a chunk on the
    second."""
    from sound_bubble_tpu_torch.runtime.fast_path import FusedStreamer

    dev = _card()
    cfg = NetConfig(use_attn=True, local_atten_len=6, **{
        **ATTN_SIZES["flagship"], "B": 2})
    net = Net(cfg).init_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    chunk, pad = cfg.stft_chunk_size, cfg.stft_pad_size
    x = rng.standard_normal((1, 6, chunk * 8 + pad)).astype(np.float32)
    outs = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False      # full fp32 convolutions
    try:
        for in_kernel in (True, False):
            fs = FusedStreamer(net, device=dev, attn_in_kernel=in_kernel)
            before = (sk.gridnet_stack_step.attn_launches,
                      sk.gridnet_stack_step.launches)
            outs[in_kernel] = torch.cat(
                [fs.feed(x[..., k * chunk:k * chunk + chunk + pad]).cpu()
                 for k in range(8)], dim=-1)
            grew = (sk.gridnet_stack_step.attn_launches - before[0],
                    sk.gridnet_stack_step.launches - before[1])
            assert grew == ((8, 0) if in_kernel else (0, 8 * cfg.B))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    want, got = outs[False], outs[True]
    assert float((got - want).abs().max() / want.abs().max()) <= TOL


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


# the routes of FusedStreamer's step: rows 1-4 at the widths of their nets
# (the flagship's, the Orange Pi's unconditioned, their attention nets with
# W cut to 7), the per-block route (the flagship's width, B cut to 2), and
# the look-back decode on row 1 at a small width
STREAM_ROUTES = {
    "row1": (dict(SIZES["full"]), True),
    "row2": (dict(CONV_SIZES["orangepi"], conv_lstm=True,
                  conditional=False), True),
    "row3": (dict(SIZES["full"], use_attn=True, L=4, E=2,
                  local_atten_len=7), True),
    "row4": (dict(CONV_SIZES["orangepi"], conv_lstm=True, conditional=False,
                  use_attn=True, L=4, E=2, local_atten_len=7), True),
    "per_block": (dict(SIZES["full"], B=2, use_attn=True, L=4, E=2,
                       local_atten_len=7), False),
    "lookback": (dict(SIZES["small"], stft_back_pad=16), True)}


def _eager_stream(net, windows, dis, in_kernel):
    """A fresh streamer's eager step (`_step_impl`) over the windows."""
    from sound_bubble_tpu_torch.runtime.fast_path import FusedStreamer

    fs = FusedStreamer(net, dis, device=windows.device,
                       attn_in_kernel=in_kernel)
    state, outs = fs._make_state(), []
    with torch.no_grad():
        for w in windows:
            out, state = fs._step_impl(w, state, fs.film)
            outs.append(out)
    return torch.cat(outs, dim=-1)


@pytest.mark.parametrize("route", list(STREAM_ROUTES))
def test_graphed_streamer_matches_the_eager_step(route):
    """FusedStreamer.feed (one captured graph of the step, replayed) and
    fused_scan_stream against the eager step in a loop, bit for bit, over
    W + 5 chunks on the attention nets (the ring wraps through the slot on
    the device) and 8 elsewhere; the launches counted as if the graph's ran
    eagerly (one a chunk, B a chunk on the per-block route) and the slot
    advanced on the device; then feed after set_dis_embed() and reset()
    against a fresh eager streamer with the new embedding."""
    from sound_bubble_tpu_torch.ops import kernels
    from sound_bubble_tpu_torch.runtime.fast_path import (
        FusedStreamer, fused_scan_stream)

    dev = _card()
    widths, in_kernel = STREAM_ROUTES[route]
    cfg = NetConfig(**{"conv_lstm": False, **widths})
    net = Net(cfg).init_weights(torch.Generator().manual_seed(0))
    n = cfg.local_atten_len + 5 if cfg.use_attn else 8
    chunk = cfg.stft_chunk_size
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(
        (1, cfg.num_ch, cfg.stft_back_pad + chunk * n + cfg.stft_pad_size))
        .astype(np.float32)).to(dev)
    windows = torch.stack([x[..., k * chunk:k * chunk + cfg.n_fft]
                           for k in range(n)])
    dis, dis2 = [[0.0, 1.0, 0.0]], [[1.0, 0.0, 0.0]]
    want = _eager_stream(net, windows, dis, in_kernel)

    fs = FusedStreamer(net, dis, device=dev, attn_in_kernel=in_kernel)
    before = kernels.launch_counts()
    got = torch.cat([fs.feed(w) for w in windows], dim=-1)
    torch.cuda.synchronize()
    grew = {k: v - before[k] for k, v in kernels.launch_counts().items()
            if v != before[k]}
    counter = "gridnet_stack_step." + ("conv_" if cfg.conv_lstm else "") + (
        "attn_launches" if cfg.use_attn and in_kernel else "launches")
    assert grew == {counter: n * (1 if in_kernel else cfg.B)}
    assert torch.equal(got, want)
    if cfg.use_attn and in_kernel:
        pos = fs.internal_state["attn_pos"]
        assert pos.dtype == torch.int32 and pos.shape == (1,)
        assert pos.device.type == "cuda"
        assert int(pos) == n % cfg.local_atten_len

    before = kernels.launch_counts()[counter]
    scan = fused_scan_stream(net, windows, dis, device=dev,
                             attn_in_kernel=in_kernel)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[counter] - before == grew[counter]
    assert torch.equal(scan, want)

    if cfg.conditional:
        fs.set_dis_embed(dis2)
        want = _eager_stream(net, windows, dis2, in_kernel)
    fs.reset()
    again = torch.cat([fs.feed(w) for w in windows], dim=-1)
    assert torch.equal(again, want)


@pytest.mark.parametrize("row", [3, 4])
def test_walk_graph_replays_advance_the_ring_slot(row):
    """Rows 3 and 4 captured with the slot's advance on the device,
    `(pos + 1) % W` in place, and replayed W + 2 times from pos = 0: replay
    k writes slot k mod W of the rings and no other, and gives what the
    eager call k gave, bit for bit."""
    dev = _card()
    cfg, packed, pa, draw = _walk_case(WALK_ROWS[row], dev, use_attn=True)
    F, D, H, B, W = cfg.n_freqs, cfg.D, cfg.H, cfg.B, cfg.local_atten_len
    x, h0, c0 = draw(F, D), draw(B, F, H) * 0.5, draw(B, F, H) * 0.5
    fw, fb = draw(B - 1, F, D), draw(B - 1, F, D)
    rings = (draw(B, cfg.L * cfg.E, W, F), draw(B, D, W, F))

    def fresh():
        return (*[r.clone() for r in rings],
                torch.zeros((1,), dtype=torch.int32, device=dev))

    def step(kr, vr, pos):
        out = sk.gridnet_stack_step_attn(packed, pa, x, h0, c0, kr, vr, pos,
                                         cfg.L, fw, fb, eps=cfg.eps)
        pos.add_(1).remainder_(W)
        return out

    with torch.no_grad():
        state = fresh()
        eager = [[t.clone() for t in step(*state)] for _ in range(W + 2)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(*fresh())
        torch.cuda.current_stream().wait_stream(side)
        state = fresh()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = step(*state)
        for k in range(W + 2):
            prev = [r.clone() for r in state[:2]]
            graph.replay()
            torch.cuda.synchronize()
            for got, want in zip(outs, eager[k]):
                assert torch.equal(got, want), k
            for ring, old in zip(state[:2], prev):
                slots = (ring != old).any(dim=3).any(dim=1).any(dim=0)
                assert torch.nonzero(slots).flatten().tolist() == [k % W]
            assert int(state[2]) == (k + 1) % W


# ---- data generation (`datagen/`): plain PyTorch on the card against the
# same calls on the CPU

def test_rirs_on_device_card_matches_cpu():
    """`campaign.rirs_on_device` on the card against the same call on the
    CPU (tests/test_campaign.py's room, order 10, a second slot with a delay
    trim): float32 image sums in another order, cos / sin of another
    library, to 1e-4 of each slot's peak."""
    from sound_bubble_tpu_torch.datagen import campaign
    from sound_bubble_tpu_torch.datagen.ism import shoebox_images

    dev = _card()
    per = [shoebox_images([5.0, 4.0, 3.0], src, 10)
           for src in ([2.0, 1.5, 1.4], [3.5, 2.5, 1.2])]
    n = max(len(im) for im, _ in per)
    images = torch.zeros(2, n, 3)
    n_refl, mask = torch.zeros(2, n), torch.zeros(2, n)
    for s, (im, nr) in enumerate(per):
        images[s, :len(im)] = torch.from_numpy(im).float()
        n_refl[s, :len(im)] = torch.from_numpy(nr).float()
        mask[s, :len(im)] = 1.0
    mics = torch.tensor([[1.0, 2.0, 1.5], [1.2, 2.1, 1.5]])
    args = (images, n_refl, mask, mics, torch.tensor(np.float32(0.6 ** .5)))
    kw = dict(fs=24000, rir_len=8192, chunk=512)
    want = campaign.rirs_on_device(*args, delay_trim=torch.tensor(
        [0.0, 300.0]), **kw)
    got = campaign.rirs_on_device(
        *(a.to(dev) for a in args),
        delay_trim=torch.tensor([0.0, 300.0], device=dev), **kw).cpu()
    rel = ((got - want).abs().amax(dim=(1, 2))
           / want.abs().amax(dim=(1, 2)))
    assert float(rel.max()) <= TOL, rel


def test_make_training_batch_card_matches_cpu():
    """`on_device.make_training_batch` on the card against the same call on
    the CPU with the same draws (made on the card, channel drop included):
    float32 FFT convolutions of another library, to 1e-4 of the peak."""
    from sound_bubble_tpu_torch.datagen import on_device as od

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    voices = torch.randn((2, 3, 4000), generator=gen, device=dev)
    rirs = 0.1 * torch.randn((2, 3, 6, 512), generator=gen, device=dev)
    target = torch.tensor([0.0, -3.0], device=dev)
    draws = od.training_batch_draws(gen, 2, 3, 6, 4000, p_drop=0.5,
                                    device=dev)
    got = od.make_training_batch(voices, rirs, 1, target, draws)

    def cpu(tree):
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        return tree.cpu()

    want = od.make_training_batch(voices.cpu(), rirs.cpu(), 1, target.cpu(),
                                  cpu(draws))
    for g, w in zip(got, want):
        (key, a), = g.items()
        b = w[key]
        assert a.device.type == "cuda"
        assert float((a.cpu() - b).abs().max() / b.abs().max()) <= TOL, key


def test_formant_speechlike_is_device_independent():
    """`voice.formant_speechlike` on the card and on the CPU from the same
    generator: one integer taken from it either way, the draws from a CPU
    generator, so the same voice up to float32 rounding."""
    from sound_bubble_tpu_torch.datagen.voice import formant_speechlike

    dev = _card()
    n, sr = 60000, 24000
    worst = 0.0
    for seed in range(8):
        rngs = np.random.default_rng(seed), np.random.default_rng(seed)
        got = formant_speechlike(rngs[0], n, sr, device=dev)
        want = formant_speechlike(rngs[1], n, sr, device="cpu")
        assert rngs[0].integers(0, 2 ** 31) == rngs[1].integers(0, 2 ** 31)
        assert got.dtype == np.float64 and got.shape == (n,)
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        print(f"seed {seed}: relative L2 {rel:.3e}, max-abs / peak "
              f"{np.abs(got - want).max() / np.abs(want).max():.3e}")
        worst = max(worst, rel)
    assert worst <= TOL
