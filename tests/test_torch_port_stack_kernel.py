"""Port parity, whole-stack step: `pack_stack_params` and the plain PyTorch
`gridnet_stack_step_ref` (and the CPU route of the `gridnet_stack_step`
wrapper) against the JAX Pallas kernel `gridnet_stack_step` run in interpret
mode on the CPU, at a small size (F=17, D=8, H=8, B=3; the conv_lstm branch
at F=25: the pack at lstm_down 5 and 4, the stack step at lstm_down 5
without FiLM and at 4, ragged, with FiLM).

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
    """3 chained steps, the state and x carried from one to the next."""
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
    got = (None, torch.from_numpy(h0), torch.from_numpy(c0))
    launches = tsk.gridnet_stack_step.conv_launches
    for _ in range(3):
        x = draw(F, D)
        want = jsk.gridnet_stack_step(
            packed_j, jnp.asarray(x), want[1], want[2],
            None if fw is None else jnp.asarray(fw),
            None if fb is None else jnp.asarray(fb), eps=cfg.eps,
            interpret=True)
        got = tsk.gridnet_stack_step(
            packed_t, torch.from_numpy(x), got[1], got[2],
            None if fw is None else torch.from_numpy(fw),
            None if fb is None else torch.from_numpy(fb), eps=cfg.eps)
        for g, w, name in zip(got, want, ("x", "h0", "c0")):
            assert tuple(g.shape) == tuple(w.shape), name
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                       rtol=0, err_msg=name)
    assert tsk.gridnet_stack_step.conv_launches == launches


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
    # affines; the rows' q | k | v and output; scores [4, 100]; moments
    assert attn["smem"] == flagship["smem"] + 4 * (
        2 * 32 * (8 + 32) + 2 * 8 + 2 * 32 + 4 + 2 * 19 * (2 * 2 + 8 + 32)
        + 19 * (16 + 64) + 400 + 26)
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
