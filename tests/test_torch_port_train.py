"""The port's training pieces against the JAX package's, on the CPU.

- losses: `neg_sdr`, the six `SNRLosses` names and `SNRLPLoss` on a batch
  with negatives (silent targets), 1e-4 absolute in dB (fp32, other order);
- optimizers: the global-norm clip + Adam / AdamW update over steps whose
  gradients are above and below the clip, and `ReduceLROnPlateau` over
  epochs, against `sound_bubble_tpu.train.optim`: parameters to 1e-6, the LR
  exactly;
- the port's seeded initial weights against the JAX package's initial
  distributions (per-leaf spread, constants exactly);
- one `PLModule` train step at a small width (B=2, D=8, H=8) from the JAX
  module's initial params (`from_jax_params`) on the seeded golden batch
  (its first 0.5 s):
  the loss to 1e-5 relative, every parameter's gradient to 1e-4 of its
  leaf's peak (a whole model in fp32, other summation orders), and the
  updated parameters (see `_check_adam_step`);
- a `best.pt` written by the port, read by the JAX package's
  `load_torch_pretrained` into its `Net`: the same forward to 1e-4 of the
  output's peak.
Inputs are drawn with numpy from seeds and handed to both packages."""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sound_bubble_tpu.losses import sdr as jsdr
from sound_bubble_tpu.losses.snrlp import SNRLPLoss as JSNRLP
from sound_bubble_tpu.train import optim as joptim
from sound_bubble_tpu.train.module import PLModule as JPLModule
from sound_bubble_tpu import utils as jutils
from sound_bubble_tpu_torch.data.synth import golden_batch
from sound_bubble_tpu_torch.losses import sdr as tsdr
from sound_bubble_tpu_torch.losses.snrlp import SNRLPLoss as TSNRLP
from sound_bubble_tpu_torch.train import optim as toptim
from sound_bubble_tpu_torch.train.module import PLModule as TPLModule
from sound_bubble_tpu_torch.weights import from_jax_params, param_tree
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "syn_experiments", "pretrain_stage.json")
SMALL = dict(D=8, H=8, B=2)


def _est_gt(seed=0, b=4, c=2, t=400):
    rng = np.random.default_rng(seed)
    gt = rng.standard_normal((b, c, t)).astype(np.float32)
    gt[1] = 0.0                     # negatives: silent targets
    gt[3] = 0.0
    est = (gt + 0.3 * rng.standard_normal((b, c, t))).astype(np.float32)
    return est, gt


@pytest.mark.parametrize("sdr_type", ["snr", "sisdr", "sdsdr"])
def test_neg_sdr_matches(sdr_type):
    est, gt = _est_gt()
    got = tsdr.neg_sdr(torch.from_numpy(est), torch.from_numpy(gt[:, ::-1]
                                                               .copy()),
                       sdr_type)
    want = jsdr.neg_sdr(jnp.asarray(est), jnp.asarray(gt[:, ::-1]), sdr_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("name", tsdr.SNRLosses.NAMES)
def test_snr_losses_and_snrlp_match(name):
    est, gt = _est_gt(1)
    te, tg = torch.from_numpy(est), torch.from_numpy(gt)
    je, jg = jnp.asarray(est), jnp.asarray(gt)
    np.testing.assert_allclose(tsdr.SNRLosses(name)(te, tg).numpy(),
                               np.asarray(jsdr.SNRLosses(name)(je, jg)),
                               atol=1e-4)
    if name in ("snr", "sisdr"):
        got = TSNRLP(name, neg_weight=100)(est=te, gt=tg)
        want = JSNRLP(name, neg_weight=100)(est=je, gt=jg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        assert got[1] == got[3] != got[0]    # one scalar for the negatives


@pytest.mark.parametrize("opt", ["Adam", "AdamW"])
def test_clip_adam_and_plateau_match_jax(opt):
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jopt = getattr(joptim, opt)(jax.tree_util.tree_map(jnp.asarray, params),
                                lr=1.2e-3, grad_clip=1.0)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    topt = getattr(toptim, opt)(list(tparams.values()), lr=1.2e-3,
                                grad_clip=1.0)
    jsched = joptim.ReduceLROnPlateau(jopt, patience=1, factor=0.5)
    tsched = toptim.ReduceLROnPlateau(topt, patience=1, factor=0.5)
    metrics = [3.0, 2.0, 2.5, 2.6, 2.7, 1.0, 1.5, 1.6]
    for epoch, metric in enumerate(metrics):
        for step in range(2):
            # norms from ~0.05 (no clip) to ~5 (clipped)
            scale = 10.0 ** rng.uniform(-1.5, 0.7)
            grads = {k: (rng.standard_normal(s) * scale).astype(np.float32)
                     for k, s in shapes.items()}
            upd, jopt.state = jopt.tx.update(
                jax.tree_util.tree_map(jnp.asarray, grads), jopt.state,
                jparams)
            jparams = jax.tree_util.tree_map(lambda p, u: p + u * jopt.lr,
                                             jparams, upd)
            for k, p in tparams.items():
                p.grad = torch.from_numpy(grads[k].copy())
            norm = topt.step()
            want_norm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                                    for g in grads.values()))
            assert float(norm) == pytest.approx(want_norm, rel=1e-5)
            for k in shapes:
                np.testing.assert_allclose(tparams[k].detach().numpy(),
                                           np.asarray(jparams[k]), atol=1e-6,
                                           err_msg=f"{opt} {k} {epoch}")
        jsched.step(metric)
        tsched.step(metric)
        assert topt.lr == jopt.lr
    assert topt.lr < 1.2e-3                  # the plateau did cut the LR


def _small_config():
    with open(CONFIG) as f:
        cfg = json.load(f)
    args = cfg["pl_module_args"]
    args["model_params"] = {**args["model_params"], **SMALL}
    return cfg


def _modules():
    args = _small_config()["pl_module_args"]
    np.random.seed(0)
    jmod = JPLModule(**args, use_dp=False)
    tmod = TPLModule(**args, device="cpu")
    port_init = {k: v.numpy().copy() for k, v in
                 tmod.net.state_dict().items()}
    tmod.net.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, jmod.params)))
    return jmod, tmod, port_init


def _leaves(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def _check_adam_step(got, want, before, grad, lr):
    """The first Adam step moves each weight by lr * g / (|g| + eps): for a
    gradient far from 0 that is +-lr whatever its size, so the updated
    weights agree to 1e-6 where |g| > 1e-3 of the leaf's peak; where the
    gradient is that close to 0, the two packages' last digits can give
    another fraction of lr, so there only |got - want| <= 2 lr holds."""
    big = np.abs(grad) > 1e-3 * np.abs(grad).max()
    np.testing.assert_allclose(got[big], want[big], atol=1e-6)
    assert np.abs(got - want).max() <= 2 * lr + 1e-6
    assert np.abs(got - before).max() > 0


def test_plmodule_train_step_matches_jax():
    jmod, tmod, port_init = _modules()
    # the port's seeded init draws from the JAX package's distributions:
    # U(-b, b) has std b / sqrt(3), so on leaves of >= 64 weights the two
    # stds agree to 20 %, and constants (LayerNorm, PReLU) agree exactly
    jax_init = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                      jmod.params))
    assert set(jax_init) == set(port_init)
    for k, w in jax_init.items():
        w, p = w.numpy(), port_init[k]
        if w.std() == 0:
            np.testing.assert_array_equal(p, w, err_msg=k)
        elif w.size >= 64:
            assert abs(p.std() / w.std() - 1) < 0.2, k
    inputs, targets = golden_batch(0)
    assert targets["num_target_speakers"][2] == 0      # a negative sample
    # the first 0.5 s of each clip keeps the CPU run short
    inputs["mixture"] = inputs["mixture"][..., :12000]
    targets["target"] = targets["target"][..., :12000]

    def jloss(params):
        out = jmod.net.apply({"params": params},
                             {k: jnp.asarray(inputs[k])
                              for k in ("mixture", "dis_embed")})
        return jnp.mean(jnp.atleast_1d(jmod.loss_fn(
            est=out["output"], gt=jnp.asarray(targets["target"]))))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(jmod.params)
    model_inputs = tmod._model_inputs(inputs)
    loss = tmod._loss(tmod.net(model_inputs)["output"],
                      torch.from_numpy(targets["target"]))
    loss.backward()
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    got_grads = {k: p.grad.numpy().copy()
                 for k, p in tmod.net.named_parameters()}
    want_flat = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                       want_grads))
    assert set(got_grads) == set(want_flat)
    for k, w in want_flat.items():
        w = w.numpy()
        err = np.abs(got_grads[k] - w).max() / max(np.abs(w).max(), 1e-12)
        assert err <= 1e-4, (k, err)

    before = {k: v.detach().numpy().copy()
              for k, v in tmod.net.state_dict().items()}
    # the JAX module's update (clip -> Adam -> x lr) applied to its grads
    upd, _ = jmod.optimizer.tx.update(want_grads, jmod.optimizer.state,
                                      jmod.params)
    after = from_jax_params(jax.tree_util.tree_map(
        lambda p, u: np.asarray(p + u * jmod.optimizer.lr), jmod.params, upd))
    tloss_step, _ = tmod.training_step((inputs, targets), 0)
    assert tloss_step == pytest.approx(float(want_loss), rel=1e-5)
    assert float(tmod.last_grad_norm) == pytest.approx(float(
        jnp.sqrt(sum(jnp.sum(g ** 2) for g in
                     jax.tree_util.tree_leaves(want_grads)))), rel=1e-4)
    lr = tmod.get_current_lr()
    for k, v in tmod.net.state_dict().items():
        _check_adam_step(v.numpy(), after[k].numpy(), before[k],
                         got_grads[k], lr)


def test_port_checkpoint_loads_in_jax(tmp_path):
    cfg = _small_config()
    np.random.seed(3)
    tmod = TPLModule(**cfg["pl_module_args"], device="cpu")
    run_dir = tmp_path / "run"
    (run_dir / "checkpoints").mkdir(parents=True)
    with open(run_dir / "config.json", "w") as f:
        json.dump(cfg, f)
    tmod.metric_values = {0: {"val/loss": {"step": None, "epoch": 1.0,
                                           "num_elements": 1}}}
    tmod.dump_state(str(run_dir / "checkpoints" / "best.pt"))

    jmod = jutils.load_torch_pretrained(str(run_dir))
    rng = np.random.default_rng(4)
    inputs = {"mixture": rng.standard_normal((1, 6, 1920)).astype(np.float32)
              * 0.1, "dis_embed": np.asarray([[0.0, 1.0, 0.0]], np.float32)}
    want = np.asarray(jmod.model(inputs)["output"])
    got = tmod.model(inputs)["output"].numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    tree = param_tree(tmod.net)
    jleaves = _leaves(jmod.params)
    assert len(jleaves) == len(_leaves(tree))
