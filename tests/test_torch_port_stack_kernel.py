"""Port parity, whole-stack step: `pack_stack_params` and the plain PyTorch
`gridnet_stack_step_ref` (and the CPU route of the `gridnet_stack_step`
wrapper) against the JAX Pallas kernel `gridnet_stack_step` run in interpret
mode on the CPU, at a small size (F=17, D=8, H=8, B=3; the conv_lstm branch
at F=25: the pack at lstm_down 5 and 4, the stack step at lstm_down 5
without FiLM and at 4, ragged, with FiLM). The cluster kernel's phases in
plain PyTorch (`walk_phases_ref`, `conv_walk_phases_ref`) are held to the
same JAX results, and its tiles and launch plan are pinned.

Tolerance 1e-5 absolute: both sides run the same fp32 math."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_bubble_tpu.models.tfgridnet.model import NetConfig as JaxConfig
from sound_bubble_tpu.ops.pallas import stack_kernel as jsk
from sound_bubble_tpu_torch.models.tfgridnet.model import Net, NetConfig
from sound_bubble_tpu_torch.ops.kernels import stack_kernel as tsk
from sound_bubble_tpu_torch.weights import param_tree
from torch_port_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
SIZE = dict(stft_chunk_size=16, stft_pad_size=16, D=8, H=8, B=3,
            conv_lstm=False, merge_method="early_cat", use_first_ln=True)
# the conv_lstm branch at F = 25
CONV = dict(stft_chunk_size=32, stft_pad_size=16, D=8, H=8, B=3,
            conv_lstm=True, merge_method="early_cat", use_first_ln=True)


def _random_tree(rng, cfg):
    """The port Net's parameter tree filled with seeded normals."""
    net = Net(cfg)
    sd = {k: torch.from_numpy(np.asarray(
              rng.standard_normal(v.shape) * 0.4, np.float32))
          for k, v in net.state_dict().items()}
    net.load_state_dict(sd)
    return param_tree(net)


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


@pytest.fixture
def case(rng):
    cfg = NetConfig(**SIZE)
    tree = _random_tree(rng, cfg)
    F, D, H, B = cfg.n_freqs, cfg.D, cfg.H, cfg.B
    assert F == 17

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    arrays = {"x": draw(F, D), "h0": draw(B, F, H) * 0.5,
              "c0": draw(B, F, H) * 0.5, "film_w": draw(B - 1, F, D),
              "film_b": draw(B - 1, F, D)}
    return cfg, tree, arrays


def test_pack_matches_jax(case):
    cfg, tree, _ = case
    got = tsk.pack_stack_params(cfg, tree)
    want = jsk.pack_stack_params(JaxConfig(**SIZE), _np_tree(tree))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("fn", ["ref", "wrapper"])
@pytest.mark.parametrize("use_film", [True, False])
def test_stack_step_matches_pallas_interpret(case, use_film, fn):
    cfg, tree, a = case
    packed_t = tsk.pack_stack_params(cfg, tree)
    packed_j = jsk.pack_stack_params(JaxConfig(**SIZE), _np_tree(tree))
    fw = a["film_w"] if use_film else None
    fb = a["film_b"] if use_film else None
    want = jsk.gridnet_stack_step(
        packed_j, jnp.asarray(a["x"]), jnp.asarray(a["h0"]),
        jnp.asarray(a["c0"]), None if fw is None else jnp.asarray(fw),
        None if fb is None else jnp.asarray(fb), eps=cfg.eps, interpret=True)
    step = (tsk.gridnet_stack_step_ref if fn == "ref"
            else tsk.gridnet_stack_step)
    launches = tsk.gridnet_stack_step.launches
    got = step(packed_t, torch.from_numpy(a["x"]), torch.from_numpy(a["h0"]),
               torch.from_numpy(a["c0"]),
               None if fw is None else torch.from_numpy(fw),
               None if fb is None else torch.from_numpy(fb), eps=cfg.eps)
    # the CPU route never counts as a kernel launch
    assert tsk.gridnet_stack_step.launches == launches
    for g, w, name in zip(got, want, ("x", "h0", "c0")):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=0, err_msg=name)


def test_wrapper_rejects_other_devices(case):
    cfg, tree, a = case
    packed = tsk.pack_stack_params(cfg, tree)
    x = torch.from_numpy(a["x"]).to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsk.gridnet_stack_step(packed, x, x, x)


def test_pack_rejects_conv_lstm(case):
    """A plain (non-conv) parameter tree packed for a conv_lstm config, and
    the other way round, raise instead of packing the wrong operands."""
    _, tree, _ = case
    with pytest.raises(ValueError, match="other intra variant"):
        tsk.pack_stack_params(NetConfig(**{**SIZE, "conv_lstm": True}), tree)
    conv_cfg = NetConfig(**{**CONV, "lstm_down": 5})
    conv_tree = _random_tree(np.random.default_rng(1), conv_cfg)
    with pytest.raises(ValueError, match="other intra variant"):
        tsk.pack_stack_params(NetConfig(**SIZE), conv_tree)


@pytest.mark.parametrize("s", [5, 4])
def test_pack_conv_matches_jax(s, rng):
    cfg = NetConfig(**CONV, lstm_down=s)
    tree = _random_tree(rng, cfg)
    got = tsk.pack_stack_params(cfg, tree)
    want = jsk.pack_stack_params(JaxConfig(**CONV, lstm_down=s),
                                 _np_tree(tree))
    # JAX's pack also carries s as an int; the port's reads it off down_cat
    assert set(got) == set(want) - {"lstm_down"}
    assert "proj_w" not in got and tsk.lstm_down(got) == want["lstm_down"] == s
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    tsk.check_packed(got, "cpu")


# (lstm_down, FiLM): F = 25 is a multiple of 5, not of 4 (ragged)
@pytest.mark.parametrize("s,use_film", [(5, False), (4, True)])
def test_stack_step_conv_matches_pallas_interpret(s, use_film, rng):
    """3 chained steps, the state and x carried from one to the next: the
    wrapper's CPU route and `conv_walk_phases_ref` (the rows-2 kernel's
    phases in its launch order: whole conv frames a block, the down conv
    and the up conv as row phases; s = 4 leaves row 24 to block 6), each
    with its own state, against the JAX Pallas kernel in interpret mode."""
    cfg = NetConfig(**CONV, lstm_down=s)
    tree = _random_tree(rng, cfg)
    F, D, H, B = cfg.n_freqs, cfg.D, cfg.H, cfg.B
    assert F == 25 and (F % s == 0) == (s == 5)
    packed_t = tsk.pack_stack_params(cfg, tree)
    packed_j = jsk.pack_stack_params(JaxConfig(**CONV, lstm_down=s),
                                     _np_tree(tree))

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    fw = draw(B - 1, F, D) if use_film else None
    fb = draw(B - 1, F, D) if use_film else None
    h0, c0 = draw(B, F, H) * 0.5, draw(B, F, H) * 0.5
    want = (None, jnp.asarray(h0), jnp.asarray(c0))
    got = {fn: (None, torch.from_numpy(h0), torch.from_numpy(c0))
           for fn in (tsk.gridnet_stack_step, tsk.conv_walk_phases_ref)}
    launches = tsk.gridnet_stack_step.conv_launches
    for _ in range(3):
        x = draw(F, D)
        want = jsk.gridnet_stack_step(
            packed_j, jnp.asarray(x), want[1], want[2],
            None if fw is None else jnp.asarray(fw),
            None if fb is None else jnp.asarray(fb), eps=cfg.eps,
            interpret=True)
        for fn, state in got.items():
            got[fn] = fn(packed_t, torch.from_numpy(x), state[1], state[2],
                         None if fw is None else torch.from_numpy(fw),
                         None if fb is None else torch.from_numpy(fb),
                         eps=cfg.eps)
            for g, w, name in zip(got[fn], want, ("x", "h0", "c0")):
                assert tuple(g.shape) == tuple(w.shape), name
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=TOL, rtol=0,
                                           err_msg=f"{fn.__name__} {name}")
    assert tsk.gridnet_stack_step.conv_launches == launches


def test_conv_walk_attn_phases_match_pallas_interpret(rng):
    """`conv_walk_phases_ref` with attention, the row-4 kernel's phases in
    plain PyTorch in its launch order (the conv tiles: a frame of 4 rows a
    block, row 24 on block 6, none on block 7), against the JAX Pallas
    `gridnet_stack_step_attn` in interpret mode, one step with FiLM: x, h0,
    c0 and both rings."""
    widths = dict(CONV, lstm_down=4, use_attn=True, L=2, E=2,
                  local_atten_len=5)
    cfg = NetConfig(**widths)
    tree = _random_tree(rng, cfg)
    jcfg = JaxConfig(**widths)
    F, D, H, B, W = cfg.n_freqs, cfg.D, cfg.H, cfg.B, cfg.local_atten_len

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    x, fw, fb = draw(F, D), draw(B - 1, F, D), draw(B - 1, F, D)
    h0, c0 = draw(B, F, H) * 0.5, draw(B, F, H) * 0.5
    kr, vr = draw(B, cfg.L * cfg.E, W, F), draw(B, D, W, F)
    pos = 3
    want = jsk.gridnet_stack_step_attn(
        jsk.pack_stack_params(jcfg, _np_tree(tree)),
        jsk.pack_attn_params(jcfg, _np_tree(tree)), *map(jnp.asarray, (
            x, h0, c0, kr, vr)), jnp.asarray([pos], jnp.int32), cfg.L,
        jnp.asarray(fw), jnp.asarray(fb), eps=cfg.eps, interpret=True)
    got = tsk.conv_walk_phases_ref(
        tsk.pack_stack_params(cfg, tree), torch.from_numpy(x),
        torch.from_numpy(h0), torch.from_numpy(c0), torch.from_numpy(fw),
        torch.from_numpy(fb), eps=cfg.eps,
        attn=(tsk.pack_attn_params(cfg, tree), torch.from_numpy(kr),
              torch.from_numpy(vr), pos, cfg.L))
    for g, w, name in zip(got, want, ("x", "h0", "c0", "k_ring", "v_ring")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=0, err_msg=name)


def test_check_packed(case):
    """`check_packed` accepts what `pack_stack_params` gives and names the
    operand that is off in dtype, shape or device."""
    cfg, tree, _ = case
    packed = tsk.pack_stack_params(cfg, tree)
    tsk.check_packed(packed, "cpu")
    with pytest.raises(TypeError, match="whh: dtype"):
        tsk.check_packed({**packed, "whh": packed["whh"].double()}, "cpu")
    with pytest.raises(ValueError, match="b8: shape"):
        tsk.check_packed({**packed, "b8": packed["b8"][:, :-1]}, "cpu")
    with pytest.raises(ValueError, match="i_ln: on cpu"):
        tsk.check_packed(packed, "meta")


@pytest.mark.parametrize("use_film", [True, False])
def test_walk_phases_match_pallas_interpret(case, use_film):
    """`walk_phases_ref`, the rows-1 kernel's phases in plain PyTorch in its
    launch order (each direction's walk on its own pack columns, the row
    phases tile by tile, the inter LSTM's recurrent part formed up front),
    against the JAX Pallas kernel in interpret mode and against
    `gridnet_stack_step_ref`, 2 chained steps (F = 17: the cluster's last
    tiles are short)."""
    cfg, tree, a = case
    packed_t = tsk.pack_stack_params(cfg, tree)
    packed_j = jsk.pack_stack_params(JaxConfig(**SIZE), _np_tree(tree))
    fw = a["film_w"] if use_film else None
    fb = a["film_b"] if use_film else None
    jfw, jfb = (None, None) if fw is None else (jnp.asarray(fw),
                                                jnp.asarray(fb))
    tfw, tfb = (None, None) if fw is None else (torch.from_numpy(fw),
                                                torch.from_numpy(fb))
    jstep = jax.jit(lambda x, h, c: jsk.gridnet_stack_step(
        packed_j, x, h, c, jfw, jfb, eps=cfg.eps, interpret=True))
    want = (None, jnp.asarray(a["h0"]), jnp.asarray(a["c0"]))
    got = ref = (None, torch.from_numpy(a["h0"]), torch.from_numpy(a["c0"]))
    for step in range(2):
        x = a["x"] * (1.0 + step)
        want = jstep(jnp.asarray(x), want[1], want[2])
        got = tsk.walk_phases_ref(packed_t, torch.from_numpy(x), got[1],
                                  got[2], tfw, tfb, eps=cfg.eps)
        ref = tsk.gridnet_stack_step_ref(packed_t, torch.from_numpy(x),
                                         ref[1], ref[2], tfw, tfb,
                                         eps=cfg.eps)
        for g, w, r, name in zip(got, want, ref, ("x", "h0", "c0")):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                       rtol=0, err_msg=f"{step} {name}")
            np.testing.assert_allclose(g.numpy(), r.numpy(), atol=TOL,
                                       rtol=0, err_msg=f"{step} {name}")


def test_walk_plan():
    """The rows-1/3 kernel's launch, checkable without a card: one cluster
    of 8 blocks of 4H threads, ceil(F / 8) rows a block, the shared memory
    of the walk (csrc/lstm_fwd32.cuh at one row) plus the block's staged
    weights, rows and scratch, the global scratch; and the widths it
    refuses."""
    flagship = tsk.walk_plan(145, 32, 64, 6)
    # the walk's 45,696 B; staged: 3 weights, 3 biases and 2 LayerNorms, 19
    # rows of c0 and FiLM; the rows: x, z, y, gates, h'
    assert flagship == {"ctas": 8, "threads": 256, "rows": 19,
                        "smem": 45696 + 4 * (7 * 64 * 32 + 6 * 32 + 4 * 64
                                             + 19 * (64 + 64)
                                             + 19 * (64 + 448)),
                        "scratch": 145 * (32 + 128 + 256 * 6)}
    attn = tsk.walk_plan(145, 32, 64, 6, (4, 2, 100))
    # staged: 4 weights, their biases and slopes, 19 rows of 4 LayerNorm
    # affines; the rows' q | k | v and output, scores [4, 100] and moments
    # (19 * 80 + 400 + 26 floats) in the gates' place (19 * 256)
    assert attn["smem"] == flagship["smem"] + 4 * (
        2 * 32 * (8 + 32) + 2 * 8 + 2 * 32 + 4 + 2 * 19 * (2 * 2 + 8 + 32))
    assert 19 * (16 + 64) + 400 + 26 <= 19 * 256
    assert attn["scratch"] == flagship["scratch"] + 8 * (26 + 400)
    assert tsk.walk_plan(17, 8, 8, 3)["threads"] == 32
    assert [n for _, n in tsk.walk_tiles(145)] == [19] * 7 + [12]
    assert tsk.walk_tiles(9) == [(0, 2), (2, 2), (4, 2), (6, 2), (8, 1),
                                 (9, 0), (9, 0), (9, 0)]
    with pytest.raises(ValueError, match="Queue 2 item 10"):
        tsk.walk_plan(145, 32, 48, 6)
    with pytest.raises(ValueError, match="multiple of 4"):
        tsk.walk_plan(145, 30, 64, 6)
    with pytest.raises(ValueError, match="shared memory"):
        tsk.walk_plan(25, 8, 8, 3, (2, 2, 40000))


def test_conv_walk_tiles_and_plan():
    """Rows 2/4's tiles and launch, checkable without a card: whole conv
    frames a block (ceil(k / 8)), the rows past the last frame on the block
    after it; the shared memory (the walk's, then the staged up conv,
    inter weights and next down conv, the vectors, 20 rows' c0 and FiLM;
    the rows' x, z, gates, h' and the 4 frames' y) and scratch at both edge
    widths, with and without attention; the widths it refuses."""
    # F = 145, s = 5: 29 frames, 4 a block, the last block 1
    tiles = tsk.conv_walk_tiles(145, 5)
    assert [nq for _, nq, _, _ in tiles] == [4] * 7 + [1]
    assert [(f0, n) for _, _, f0, n in tiles] == \
        [(20 * c, 20) for c in range(7)] + [(140, 5)]
    # F = 25, s = 4: 6 frames, one a block; row 24 on block 6
    assert tsk.conv_walk_tiles(25, 4) == [
        (c, 1, 4 * c, 4) for c in range(6)] + [(6, 0, 24, 1), (6, 0, 24, 0)]
    # s = 1 is the plain intra's tiling
    assert [(f0, n) for _, _, f0, n in tsk.conv_walk_tiles(145, 1)] == \
        tsk.walk_tiles(145)
    for d, walk in ((24, 37248), (16, 28800)):
        staged = (15 * 64 * d + 6 * d + 256 + 20 * (64 + 2 * d)
                  + 5 * d * d + d + 1)
        own = 20 * (2 * d + 320) + 4 * 128
        plan = tsk.conv_walk_plan(145, d, 64, 3, 5)
        assert plan == {"ctas": 8, "threads": 256, "rows": 20, "frames": 4,
                        "smem": walk + 4 * (-(-staged // 4) * 4 + own),
                        "scratch": 29 * (d + 128) + 145 * 256 * 3}
        assert walk == tsk.fwd_smem(d, 64, 1)
        attn = tsk.conv_walk_plan(145, d, 64, 3, 5, (4, 2, 100))
        assert attn["scratch"] == plan["scratch"] + 8 * (26 + 400)
        assert plan["smem"] < attn["smem"] <= tsk.SMEM_LIMIT_BYTES
    assert tsk.conv_walk_plan(145, 24, 64, 3, 5)["smem"] == 183088
    # with attention, within the 196 KB shared-memory configuration (200,704
    # B less the 1 KB the card keeps a block), as row 3 is
    assert tsk.conv_walk_plan(145, 24, 64, 3, 5, (4, 2, 100))["smem"] == \
        194944
    with pytest.raises(ValueError, match="Queue 2 item 10"):
        tsk.conv_walk_plan(145, 24, 48, 3, 5)
    with pytest.raises(ValueError, match="multiple of 4"):
        tsk.conv_walk_plan(145, 22, 64, 3, 5)
    with pytest.raises(ValueError, match="no conv frame"):
        tsk.conv_walk_plan(3, 8, 8, 3, 4)
    with pytest.raises(ValueError, match="shared memory"):
        tsk.conv_walk_plan(145, 40, 64, 3, 5)
