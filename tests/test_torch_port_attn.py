"""Port parity, local causal attention (`use_attn=True`): the port's
attention modules, the attention stack step and the attention nets against
the JAX package on the same weights (`from_jax_params`) and the same numpy
inputs, on the CPU. Tolerance 1e-5 absolute (fp32 both sides, other
summation order) unless stated.

- `AttnProj` and `local_attention` at T < W, T = W and T > W with T not a
  multiple of W (the banded and the blocked path);
- one `GridNetBlock` with attention: output, K/V buffers, the input's and
  every weight's gradient (each within 1e-5 of max(1, its leaf's peak));
- the small attention net (`tools/attn_tpu_smoke.py:SMALL`: F=25, D=8,
  B=3, H=8, L=2, E=2, W=5), plain and conv_lstm, conditioned and not:
  offline output against JAX, and the port's `ModelWrapper` stream against
  the port's offline output, 1e-4 (the repo's whole-model bar);
- `pack_attn_params` against JAX, key for key and exactly;
- `gridnet_stack_step_attn_ref` (and the CPU route of the wrapper) against
  the JAX Pallas `gridnet_stack_step_attn` in interpret mode over W + 2
  chained steps (pos wraps the ring), plain and conv branch: x, h0, c0 and
  both rings;
- `FusedStreamer` on the CPU, both routes (`attn_in_kernel` True on both
  branches, False on the plain one), against the JAX `FusedStreamer`
  (interpret mode) over W + 2 chunks, 1e-4;
- the eps hazard: with `eps=1e-3` the attention LayerNorms keep 1e-5 (as
  in JAX) while the intra and inter ones take 1e-3; the port's model, its
  streamer and the JAX model agree, 1e-4;
- one `PLModule` train step on a small attention net (the pretrain
  config, D=8, B=1, H=8, L=2, W=20, on 0.3 s: the blocked path): the loss
  to 1e-5 relative and every gradient to 1e-4 of its leaf's peak;
- one production-width case: the seeded attention flagship
  (`runs/attn_flagship_seeded`, `tools/jax_goldens_attn.py`) streamed
  through the port's `FusedStreamer` (the plain stack step) over the first
  25 chunks of `test_samples/syn_1m/00002`, against the JAX stream's first
  20 chunks in `runs/goldens_attn_jax.json`, 1e-4 of the output's peak."""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_bubble_tpu.models.tfgridnet import model as jmodel
from sound_bubble_tpu.ops.pallas import stack_kernel as jsk
from sound_bubble_tpu.runtime.fast_path import FusedStreamer as JaxStreamer
from sound_bubble_tpu_torch.evaluation import load_testcase, one_hot
from sound_bubble_tpu_torch.models.tfgridnet import model as tmodel
from sound_bubble_tpu_torch.ops.kernels import stack_kernel as tsk
from sound_bubble_tpu_torch.runtime.fast_path import FusedStreamer
from sound_bubble_tpu_torch.runtime.streaming import (
    ModelWrapper, streaming_inference)
from sound_bubble_tpu_torch.train.module import PLModule as TPLModule
from sound_bubble_tpu_torch.utils import load_pretrained
from sound_bubble_tpu_torch.weights import from_jax_params, param_tree
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
STREAM_TOL = 1e-4
# tools/attn_tpu_smoke.py:SMALL (F = 48 // 2 + 1 = 25)
SMALL = dict(stft_chunk_size=32, stft_pad_size=16, num_ch=6, D=8, B=3, H=8,
             L=2, E=2, chunk_causal=True, use_first_ln=True,
             merge_method="early_cat", dis_type="conv3",
             use_attn=True, local_atten_len=5)
VARIANTS = {"plain": dict(conv_lstm=False), "conv": dict(conv_lstm=True,
                                                         lstm_down=4)}
DIS = np.asarray([[0.0, 1.0, 0.0]], np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nets(model_params, conditional=True, seed=0):
    """The JAX net, its params from `seed` and the port's net on them."""
    jnet = jmodel.make_net(model_params, conditional=conditional)
    cfg = jnet.cfg
    dummy = {"mixture": jnp.zeros((1, cfg.num_ch, cfg.n_fft), jnp.float32),
             "dis_embed": jnp.asarray(DIS)}
    params = jax.jit(jnet.init)(jax.random.PRNGKey(seed), dummy)["params"]
    net = tmodel.Net(tmodel.make_config(model_params, conditional))
    net.load_state_dict(from_jax_params(_np_tree(params)))
    return jnet, params, net.eval()


def _japply(jnet, params, inputs, pad=True):
    """The JAX net's output (jitted: much faster than eager on the CPU)."""
    fn = jax.jit(functools.partial(jnet.apply, pad=pad))
    return np.asarray(fn({"params": params}, {
        k: jnp.asarray(v) for k, v in inputs.items()})["output"])


def _signal(rng, cfg, n):
    return rng.standard_normal(
        (1, cfg.num_ch, cfg.stft_back_pad + cfg.stft_chunk_size * n
         + cfg.stft_pad_size)).astype(np.float32) * 3


@pytest.mark.parametrize("T", [3, 5, 12])
def test_attn_proj_and_local_attention_match_jax(T, rng):
    """W = 5: T < W and T = W take the banded path, T = 12 the blocked one
    (3 blocks, the last one 2 rows)."""
    F, C, L, E, W = 25, 8, 2, 2, 5
    x = rng.standard_normal((2, T, F, C)).astype(np.float32)
    jproj = jmodel.AttnProj(L, E)
    params = jproj.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    # a LayerNorm affine away from (1, 0) and a slope away from 0.25
    params = jax.tree_util.tree_map(
        lambda a: a + 0.3 * jax.random.normal(jax.random.PRNGKey(a.size),
                                              a.shape), params)
    proj = tmodel.AttnProj(C, F, L, E)
    proj.load_state_dict(from_jax_params(_np_tree(params)))
    want = np.asarray(jproj.apply({"params": params}, jnp.asarray(x)))
    got = proj(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, L, T, F * E)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)

    q = rng.standard_normal((2, L, T, F * E)).astype(np.float32)
    k = rng.standard_normal((2, L, T + W - 1, F * E)).astype(np.float32)
    v = rng.standard_normal((2, L, T + W - 1, F * 4)).astype(np.float32)
    want = np.asarray(jmodel._local_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), W))
    got = tmodel.local_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), W).numpy()
    assert got.shape == want.shape == (2, L, T, F * 4)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_gridnet_block_attn_matches_jax(variant, rng):
    """T = 7 frames after W-1 = 4 buffered ones: output, h0, K/V buffers,
    and the gradients of a loss on the output and the new K/V buffers."""
    jcfg = jmodel.NetConfig(**{**SMALL, **VARIANTS[variant]})
    F, C, H, W = jcfg.n_freqs, jcfg.D, jcfg.H, jcfg.local_atten_len
    vd = C // jcfg.L
    x = rng.standard_normal((2, 7, F, C)).astype(np.float32)
    state = {"h0": 0.5 * rng.standard_normal((2, F, H)),
             "c0": 0.5 * rng.standard_normal((2, F, H)),
             "K_buf": rng.standard_normal((2, jcfg.L, W - 1, F * jcfg.E)),
             "V_buf": rng.standard_normal((2, jcfg.L, W - 1, F * vd))}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    cots = {k: rng.standard_normal(s).astype(np.float32) for k, s in (
        ("x", x.shape), ("K_buf", state["K_buf"].shape),
        ("V_buf", state["V_buf"].shape))}
    jblk = jmodel.GridNetBlock(jcfg)
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    params = jax.jit(jblk.init)(jax.random.PRNGKey(1), jnp.asarray(x),
                                jstate)["params"]

    def f(p, xx):
        y, st = jblk.apply({"params": p}, xx, jstate)
        return (jnp.sum(y * cots["x"]) + jnp.sum(st["K_buf"] * cots["K_buf"])
                + jnp.sum(st["V_buf"] * cots["V_buf"]))

    want, want_st = jax.jit(jblk.apply)({"params": params}, jnp.asarray(x),
                                        jstate)
    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(params, jnp.asarray(x))

    blk = tmodel.GridNetBlock(tmodel.NetConfig(**{**SMALL,
                                                  **VARIANTS[variant]}))
    blk.load_state_dict(from_jax_params(_np_tree(params)))
    xt = torch.from_numpy(x).requires_grad_()
    got, got_st = blk(xt, {k: torch.from_numpy(v) for k, v in state.items()})
    ((got * torch.from_numpy(cots["x"])).sum()
     + (got_st["K_buf"] * torch.from_numpy(cots["K_buf"])).sum()
     + (got_st["V_buf"] * torch.from_numpy(cots["V_buf"])).sum()).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0)
    assert set(got_st) == set(want_st) == {"h0", "c0", "K_buf", "V_buf"}
    for key in got_st:
        np.testing.assert_allclose(got_st[key].detach().numpy(),
                                   np.asarray(want_st[key]), atol=TOL,
                                   rtol=0, err_msg=key)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=TOL,
                               rtol=0)
    want_g = {k: v.numpy() for k, v in from_jax_params(_np_tree(gp)).items()}
    got_g = {k: p.grad.numpy() for k, p in blk.named_parameters()}
    assert set(got_g) == set(want_g)
    assert {"attn_q.proj.kernel", "attn_out_norm.scale"} <= set(got_g)
    for k in got_g:
        scale = max(1.0, float(np.abs(want_g[k]).max()))
        np.testing.assert_allclose(got_g[k], want_g[k], atol=TOL * scale,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("conditional", [True, False])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_small_attn_net_offline_and_streamed(variant, conditional, rng):
    """13 frames (T > W, ragged blocks) offline against JAX; the same
    signal streamed through the port's ModelWrapper against the port's
    offline output with pad=False."""
    mp = {**SMALL, **VARIANTS[variant]}
    jnet, params, net = _nets(mp, conditional)
    cfg = net.cfg
    x = _signal(rng, cfg, 12)
    inputs = {"mixture": x, "dis_embed": DIS}
    want = _japply(jnet, params, inputs)
    with torch.no_grad():
        got = net({k: torch.from_numpy(v) for k, v in inputs.items()})
        offline = net({k: torch.from_numpy(v) for k, v in inputs.items()},
                      pad=False)["output"].numpy()
    np.testing.assert_allclose(got["output"].numpy(), want, atol=STREAM_TOL,
                               rtol=0)
    streamed = streaming_inference(
        ModelWrapper(net, device="cpu"), x, cfg.stft_chunk_size,
        cfg.stft_pad_size, dis_embed=DIS if conditional else None).numpy()
    assert streamed.shape == offline.shape
    np.testing.assert_allclose(streamed, offline, atol=STREAM_TOL, rtol=0)


def test_pack_attn_params_matches_jax():
    cfg = tmodel.NetConfig(**SMALL)
    rng = np.random.default_rng(2)
    net = tmodel.Net(cfg)
    net.load_state_dict({k: torch.from_numpy(np.asarray(
        rng.standard_normal(v.shape), np.float32))
        for k, v in net.state_dict().items()})
    tree = param_tree(net)
    got = tsk.pack_attn_params(cfg, tree)
    want = jsk.pack_attn_params(jmodel.NetConfig(**SMALL), jax.tree_util.
                                tree_map(lambda t: t.numpy(), tree))
    assert set(got) == set(want) == set(tsk._ATTN)
    for k in got:
        assert got[k].dtype == torch.float32 and got[k].is_contiguous()
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_attn_stack_step_matches_pallas_interpret(variant):
    """The plain version and the wrapper's CPU route, each with its own
    state, against one jitted JAX chain."""
    cfg = tmodel.NetConfig(**{**SMALL, **VARIANTS[variant]})
    jcfg = jmodel.NetConfig(**{**SMALL, **VARIANTS[variant]})
    rng = np.random.default_rng(4)
    net = tmodel.Net(cfg)
    net.load_state_dict({k: torch.from_numpy(np.asarray(
        rng.standard_normal(v.shape) * 0.4, np.float32))
        for k, v in net.state_dict().items()})
    tree = param_tree(net)
    jtree = jax.tree_util.tree_map(lambda t: t.numpy(), tree)
    pk_t, pa_t = tsk.pack_stack_params(cfg, tree), tsk.pack_attn_params(
        cfg, tree)
    pk_j, pa_j = jsk.pack_stack_params(jcfg, jtree), jsk.pack_attn_params(
        jcfg, jtree)
    F, D, H, B, W = cfg.n_freqs, cfg.D, cfg.H, cfg.B, cfg.local_atten_len

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    fw, fb = draw(B - 1, F, D), draw(B - 1, F, D)
    h, c = draw(B, F, H) * 0.5, draw(B, F, H) * 0.5
    kr, vr = np.zeros((B, cfg.L * cfg.E, W, F), np.float32), np.zeros(
        (B, D, W, F), np.float32)
    jstep = jax.jit(lambda x, h, c, kr, vr, pos: jsk.gridnet_stack_step_attn(
        pk_j, pa_j, x, h, c, kr, vr, pos, cfg.L, jnp.asarray(fw),
        jnp.asarray(fb), eps=cfg.eps, interpret=True))
    jstate = [jnp.asarray(a) for a in (h, c, kr, vr)]
    states = {fn: [torch.from_numpy(a.copy()) for a in (h, c, kr, vr)]
              for fn in (tsk.gridnet_stack_step_attn_ref,
                         tsk.gridnet_stack_step_attn)}
    for k in range(W + 2):
        x = draw(F, D)
        jx, *jstate = jstep(jnp.asarray(x), *jstate,
                            jnp.asarray([k % W], jnp.int32))
        for fn, st in states.items():
            tx, *st[:] = fn(pk_t, pa_t, torch.from_numpy(x), *st, k % W,
                            cfg.L, torch.from_numpy(fw),
                            torch.from_numpy(fb), eps=cfg.eps)
            for name, g, w in zip(("x", "h0", "c0", "k_ring", "v_ring"),
                                  [tx, *st], [jx, *jstate]):
                np.testing.assert_allclose(
                    g.numpy(), np.asarray(w), atol=TOL, rtol=0,
                    err_msg=f"{fn.__name__} step {k} {name}")


def test_walk_attn_phases_match_pallas_interpret():
    """`walk_phases_ref` with attention, the row-3 kernel's phases in plain
    PyTorch in its launch order (q, k, v and each slab's LayerNorm
    partials a tile of rows; the combine; the ring slot and partial scores;
    the softmax and weighted values; the frame LayerNorm's partials and
    combine), against the jitted JAX Pallas `gridnet_stack_step_attn` in
    interpret mode over W + 1 chained steps (pos wraps): x, h0, c0 and both
    rings. F = 25: the cluster's tiles are 4 rows, the last one 0."""
    cfg = tmodel.NetConfig(**SMALL, conv_lstm=False)
    jcfg = jmodel.NetConfig(**SMALL, conv_lstm=False)
    rng = np.random.default_rng(5)
    net = tmodel.Net(cfg)
    net.load_state_dict({k: torch.from_numpy(np.asarray(
        rng.standard_normal(v.shape) * 0.4, np.float32))
        for k, v in net.state_dict().items()})
    tree = param_tree(net)
    jtree = jax.tree_util.tree_map(lambda t: t.numpy(), tree)
    pk_t, pa_t = tsk.pack_stack_params(cfg, tree), tsk.pack_attn_params(
        cfg, tree)
    pk_j, pa_j = jsk.pack_stack_params(jcfg, jtree), jsk.pack_attn_params(
        jcfg, jtree)
    F, D, H, B, W = cfg.n_freqs, cfg.D, cfg.H, cfg.B, cfg.local_atten_len

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    fw, fb = draw(B - 1, F, D), draw(B - 1, F, D)
    h, c = draw(B, F, H) * 0.5, draw(B, F, H) * 0.5
    kr, vr = np.zeros((B, cfg.L * cfg.E, W, F), np.float32), np.zeros(
        (B, D, W, F), np.float32)
    jstep = jax.jit(lambda x, h, c, kr, vr, pos: jsk.gridnet_stack_step_attn(
        pk_j, pa_j, x, h, c, kr, vr, pos, cfg.L, jnp.asarray(fw),
        jnp.asarray(fb), eps=cfg.eps, interpret=True))
    jstate = [jnp.asarray(a) for a in (h, c, kr, vr)]
    st = [torch.from_numpy(a.copy()) for a in (h, c, kr, vr)]
    for k in range(W + 1):
        x = draw(F, D)
        jx, *jstate = jstep(jnp.asarray(x), *jstate,
                            jnp.asarray([k % W], jnp.int32))
        tx, *st[:] = tsk.walk_phases_ref(
            pk_t, torch.from_numpy(x), st[0], st[1], torch.from_numpy(fw),
            torch.from_numpy(fb), eps=cfg.eps,
            attn=(pa_t, st[2], st[3], k % W, cfg.L))
        for name, g, w in zip(("x", "h0", "c0", "k_ring", "v_ring"),
                              [tx, *st], [jx, *jstate]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                       rtol=0, err_msg=f"step {k} {name}")

@pytest.mark.parametrize("variant,in_kernel", [
    ("plain", True), ("conv", True), ("plain", False)])
def test_fused_streamer_attn_matches_jax(variant, in_kernel, rng):
    jnet, params, net = _nets({**SMALL, **VARIANTS[variant]})
    cfg = net.cfg
    n = cfg.local_atten_len + 2
    x = _signal(rng, cfg, n)
    chunk, width = cfg.stft_chunk_size, cfg.n_fft
    windows = [x[..., k * chunk:k * chunk + width] for k in range(n)]
    jfs = JaxStreamer(jnet, params, DIS, interpret=True,
                      attn_in_kernel=in_kernel)
    want = np.concatenate([np.asarray(jfs.feed(jnp.asarray(w)))
                           for w in windows], axis=-1)
    fs = FusedStreamer(net, DIS, device="cpu", attn_in_kernel=in_kernel)
    assert (fs.packed_attn is not None) == in_kernel
    before = (tsk.gridnet_stack_step.attn_launches,
              tsk.gridnet_stack_step.conv_attn_launches)
    got = torch.cat([fs.feed(w) for w in windows], dim=-1).numpy()
    # the CPU route runs the plain versions: no kernel launch
    assert (tsk.gridnet_stack_step.attn_launches,
            tsk.gridnet_stack_step.conv_attn_launches) == before
    if in_kernel:
        assert fs.internal_state["attn_pos"] == n % cfg.local_atten_len
    assert got.shape == want.shape == (1, 1, chunk * n)
    np.testing.assert_allclose(got, want, atol=STREAM_TOL, rtol=0)


def test_attn_layer_norms_keep_their_eps(rng):
    """eps=1e-3: the intra and inter LayerNorms take it, the attention ones
    keep flax's default 1e-5 in the JAX model and the Pallas kernel; the
    port's model and both streamer routes agree with the JAX model."""
    mp = {**SMALL, **VARIANTS["plain"], "eps": 1e-3}
    jnet, params, net = _nets(mp)
    cfg = net.cfg
    assert cfg.eps == 1e-3 and tsk.ATTN_LN_EPS == 1e-5
    blk = net.blocks()[0]
    assert blk.inter_norm.eps == 1e-3 and blk.intra.norm.eps == 1e-3
    assert blk.attn_q.norm.eps == blk.attn_out_norm.eps == 1e-5
    x = _signal(rng, cfg, 6)
    want = _japply(jnet, params, {"mixture": x, "dis_embed": DIS},
                   pad=False)
    with torch.no_grad():
        got = net({"mixture": torch.from_numpy(x),
                   "dis_embed": torch.from_numpy(DIS)}, pad=False)["output"]
    np.testing.assert_allclose(got.numpy(), want, atol=STREAM_TOL, rtol=0)
    chunk = cfg.stft_chunk_size
    for in_kernel in (True, False):
        fs = FusedStreamer(net, DIS, device="cpu", attn_in_kernel=in_kernel)
        streamed = torch.cat([fs.feed(x[..., k * chunk:k * chunk
                                        + cfg.n_fft]) for k in range(6)],
                             dim=-1).numpy()
        np.testing.assert_allclose(streamed, want, atol=STREAM_TOL, rtol=0)


def test_plmodule_attn_train_step_matches_jax():
    from sound_bubble_tpu.train.module import PLModule as JPLModule

    with open(os.path.join(REPO, "syn_experiments",
                           "pretrain_stage.json")) as f:
        args = json.load(f)["pl_module_args"]
    args["model_params"] = {**args["model_params"], "D": 8, "H": 8, "B": 1,
                            "L": 2, "use_attn": True, "local_atten_len": 20}
    np.random.seed(0)
    jmod = JPLModule(**args, use_dp=False)
    tmod = TPLModule(**args, device="cpu")
    tmod.net.load_state_dict(from_jax_params(_np_tree(jmod.params)))
    rng = np.random.default_rng(5)
    # 0.3 s: 38 frames, two blocks of W = 20 (the blocked path)
    inputs = {"mixture": rng.standard_normal((2, 6, 7200)).astype(
        np.float32), "dis_embed": np.eye(3, dtype=np.float32)[[0, 2]]}
    target = rng.standard_normal((2, 1, 7200)).astype(np.float32) * 0.3

    def jloss(p):
        out = jmod.net.apply({"params": p}, {k: jnp.asarray(v)
                                             for k, v in inputs.items()})
        return jnp.mean(jnp.atleast_1d(jmod.loss_fn(
            est=out["output"], gt=jnp.asarray(target))))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(jmod.params)
    loss = tmod._loss(tmod.net(tmod._model_inputs(inputs))["output"],
                      torch.from_numpy(target))
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    want = {k: v.numpy() for k, v in from_jax_params(
        _np_tree(want_grads)).items()}
    # with B=1 no FiLM reads the distance embedding: torch leaves its grads
    # None, JAX gives zeros
    got = {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
           for k, p in tmod.net.named_parameters()}
    assert set(got) == set(want)
    assert any(k.startswith("block0.attn_v.") for k in got)
    for k, w in want.items():
        err = np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-12)
        assert err <= 1e-4, (k, err)


def test_bf16_trunk_with_attention_raises():
    cfg = tmodel.NetConfig(**{**SMALL, "compute_dtype": "bf16"})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodel.Net(cfg)
    with open(os.path.join(REPO, "runs", "attn_orangpi_seeded",
                           "config.json")) as f:
        args = json.load(f)["pl_module_args"]
    args["model_params"] = {**args["model_params"], "D": 8, "H": 8, "B": 1}
    args.pop("init_ckpt")
    mod = TPLModule(**args, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mod.set_bf16_trunk()
    assert mod.net.cfg.compute_dtype is None
    net = tmodel.Net(tmodel.NetConfig(**SMALL))
    net.cfg = dataclasses.replace(net.cfg, compute_dtype="bf16")
    with pytest.raises(NotImplementedError, match="bf16 serving"):
        FusedStreamer(net, device="cpu")


def test_attn_flagship_streamed_matches_jax_head():
    """The seeded attention flagship at full width (F=145, D=32, B=6, H=64,
    L=4, E=2, W=100), the in-kernel route's plain version on the CPU."""
    with open(os.path.join(REPO, "runs", "goldens_attn_jax.json")) as f:
        head = json.load(f)["flagship"]["head"]
    net = load_pretrained(os.path.join(REPO, "runs", "attn_flagship_seeded"),
                          device="cpu")
    cfg = net.cfg
    assert cfg.use_attn and (cfg.n_freqs, cfg.D, cfg.B, cfg.L, cfg.E,
                             cfg.local_atten_len) == (145, 32, 6, 4, 2, 100)
    _, mixture, _, _, _ = load_testcase(
        os.path.join(REPO, "test_samples", head["sample"]), 24000, 1.0)
    chunk, pad = cfg.stft_chunk_size, cfg.stft_pad_size
    fs = FusedStreamer(net, one_hot(1.0), device="cpu")
    x = torch.from_numpy(mixture[None, :, :25 * chunk + pad])
    got = torch.cat([fs.feed(x[..., k * chunk:k * chunk + chunk + pad])
                     for k in range(25)], dim=-1)[0, 0].numpy()
    want = np.asarray(head["output"], np.float32)
    n = head["chunks"] * chunk
    assert float(np.abs(got[:n] - want).max()
                 / np.abs(want).max()) <= STREAM_TOL
    assert np.isfinite(got).all()
