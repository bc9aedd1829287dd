"""PLModule, the training runtime (port of `sound_bubble_tpu/train/module.py`).

Same public surface as the JAX package's (and the reference's HL module):
training_step / validation_step / on_epoch_start / on_epoch_end /
dump_state / load_state / train / eval / log_metric / log_statistic /
get_current_lr / get_avg_metric_at_epoch, and `model` for the eval CLIs.

One train step is forward -> loss -> backward -> global-norm clip -> Adam,
eagerly on one device. The loss is the mean of the per-sample losses (or the
scalar loss): the JAX package's mask-weighted mean with every weight 1, since
one device never pads a batch to a device multiple. Audio samples are not
logged; the metrics go to the local JSONL run log (`train/logging.py`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sound_bubble_tpu_torch.metrics.metrics import Metrics, compute_decay
from sound_bubble_tpu_torch.models.tfgridnet.model import check_supported
from sound_bubble_tpu_torch.train.checkpoint import (
    load_checkpoint, model_tree, save_checkpoint)
from sound_bubble_tpu_torch.train.optim import ReduceLROnPlateau
from sound_bubble_tpu_torch.utils import import_attr, resolve_device
from sound_bubble_tpu_torch.weights import from_jax_params


class PLModule:
    def __init__(self, model, model_params, sr,
                 optimizer, optimizer_params,
                 scheduler=None, scheduler_params=None,
                 loss=None, loss_params=None,
                 metrics=(), init_ckpt=None,
                 grad_clip=None,
                 use_dp=True,               # one device: accepted, unused
                 val_log_interval=10,       # unused, kept for config parity
                 samples_per_speaker_number=3,   # audio logging: not ported
                 device="cuda", lstm_scan="slab", pallas_blstm=False):
        self.device = resolve_device(device)
        # the LSTM scans' kernel route ("slab" or "seq", ops/rnn.py); the
        # fused inference BLSTM (row 5) for the eval CLIs' forward
        self.net = import_attr(model)(**model_params, lstm_scan=lstm_scan,
                                      pallas_blstm=pallas_blstm)
        self.sr = sr
        self.metrics = [Metrics(m) for m in metrics]
        self.metric_values = {}
        self.statistics = {}
        self.monitor = "val/loss"
        self.monitor_mode = "min"
        self.snr_metric = Metrics("snr")
        self.loss_fn = import_attr(loss)(**loss_params)
        self.grad_clip = grad_clip
        self.last_grad_norm = None

        # weights from the seeded global numpy generator, as the JAX package
        # draws its init key
        gen = torch.Generator().manual_seed(
            int(np.random.randint(0, 2 ** 31 - 1)))
        self.net.init_weights(gen)
        if init_ckpt is not None:
            state = load_checkpoint(init_ckpt)
            weights = state["model"] if "model" in state else state[
                "state_dict"]
            self.net.load_state_dict(from_jax_params(weights))
            print(f"Warm-started weights from {init_ckpt}")
        self.net.to(self.device)

        self.optim_name = optimizer
        self.opt_params = optimizer_params
        self.scheduler_name = scheduler
        self.scheduler_params = scheduler_params
        self._build_optimizer()
        self.epoch = 0

    def set_bf16_trunk(self):
        """Run the net's trunk in bf16 (`compute_dtype="bf16"`) with the
        float32 params as they are (`train_pt --bf16`; `train_stream --bf16`
        casts the params too)."""
        cfg = dataclasses.replace(self.net.cfg, compute_dtype="bf16")
        check_supported(cfg)
        self.net.cfg = cfg

    def _build_optimizer(self):
        self.optimizer = import_attr(self.optim_name)(
            self.net.parameters(), grad_clip=self.grad_clip,
            **self.opt_params)
        self.scheduler = self.init_scheduler(self.scheduler_name,
                                             self.scheduler_params)

    # ------------------------------------------------------- reference API --
    def load_state(self, path):
        state = load_checkpoint(path)
        self.net.load_state_dict(from_jax_params(state["model"]))
        self._build_optimizer()
        self.optimizer.load_state_dict(state["optimizer"])
        if self.scheduler is not None and "scheduler" in state:
            self.scheduler.load_state_dict(state["scheduler"])
        self.epoch = state["current_epoch"]
        self.metric_values = state["metric_values"]
        self.statistics = state.get("statistics", {})

    def dump_state(self, path):
        state = dict(model=model_tree(self.net),
                     optimizer=self.optimizer.state_dict(),
                     current_epoch=self.epoch,
                     metric_values=self.metric_values,
                     statistics=self.statistics)
        if self.scheduler is not None:
            state["scheduler"] = self.scheduler.state_dict()
        save_checkpoint(path, state)

    def get_current_lr(self):
        return self.optimizer.lr

    def on_epoch_start(self):
        print()
        print("=" * 25, "STARTING EPOCH", self.epoch, "=" * 25)
        print()

    def get_avg_metric_at_epoch(self, metric, epoch=None):
        epoch = self.epoch if epoch is None else epoch
        entry = self.metric_values[epoch][metric]
        return entry["epoch"] / entry["num_elements"]

    def on_epoch_end(self, best_path, run_log):
        """Save best_path when this epoch's monitored metric is the best so
        far, log the epoch's averages to run_log (a `LocalRun`), step the
        scheduler and advance the epoch."""
        if self.epoch + 1 != len(self.metric_values):
            raise RuntimeError("the current epoch must equal the number of "
                               "epochs with metrics (0-indexed)")
        monitor_last = self.get_avg_metric_at_epoch(self.monitor)
        save = True
        for epoch in range(len(self.metric_values) - 1):
            at_epoch = self.get_avg_metric_at_epoch(self.monitor, epoch)
            if self.monitor_mode == "max" and monitor_last < at_epoch:
                save = False
                break
            if self.monitor_mode == "min" and monitor_last > at_epoch:
                save = False
                break
        if save:
            print("Current checkpoint is the best! Saving it...")
            self.dump_state(best_path)

        print(f"Val loss: {self.get_avg_metric_at_epoch('val/loss'):.02f}")
        for name in ("val/snr_i", "val/si_snr_i", "val/si_sdr_i"):
            if name in self.metric_values[self.epoch]:
                print(f"{name}: {self.get_avg_metric_at_epoch(name):.02f}dB")

        step = self.epoch + 1
        run_log.log({"lr-Adam": self.get_current_lr()}, commit=False,
                    step=step)
        for metric in self.metric_values[self.epoch]:
            run_log.log({metric: self.get_avg_metric_at_epoch(metric)},
                        commit=False, step=step)
        for name, stat in self.statistics.items():
            if not stat["logged"]:
                key = name + "/mean" if stat["reduction"] == "histogram" \
                    else name
                red = np.sum if stat["reduction"] == "sum" else np.mean
                run_log.log({key: float(red(stat["data"]))}, commit=False)
                stat["logged"] = True
        run_log.log({"epoch": self.epoch}, commit=True, step=step)

        if self.scheduler is not None:
            if isinstance(self.scheduler, ReduceLROnPlateau):
                self.scheduler.step(monitor_last)
            else:
                self.scheduler.step()
        self.epoch += 1

    def log_statistic(self, name, value, reduction="mean"):
        if reduction not in ("mean", "sum", "histogram"):
            raise ValueError(f"Unknown reduction {reduction}.")
        if name not in self.statistics:
            self.statistics[name] = dict(logged=False, data=[],
                                         reduction=reduction)
        self.statistics[name]["data"].append(value)

    def log_metric(self, name, value, batch_size=1, on_step=False,
                   on_epoch=True):
        store = self.metric_values.setdefault(self.epoch, {})
        entry = store.setdefault(name, dict(step=None, epoch=None))
        value = float(value)
        if on_step:
            if entry["step"] is None:
                entry["step"] = []
            entry["step"].append(value)
        if on_epoch:
            if entry["epoch"] is None:
                entry["epoch"] = 0
                entry["num_elements"] = 0
            entry["epoch"] += value * batch_size
            entry["num_elements"] += batch_size

    # --------------------------------------------------------------- steps --
    def _model_inputs(self, inputs):
        keep = {"mixture", "label"}
        if self.net.cfg.conditional:
            keep.add("dis_embed")
        return {k: torch.as_tensor(np.asarray(v, np.float32)).to(self.device)
                for k, v in inputs.items() if k in keep}

    def _loss(self, est, target):
        return torch.atleast_1d(self.loss_fn(est=est, gt=target)).mean()

    def train_step(self, model_inputs, target):
        """Forward, loss, backward, clip and optimizer step on tensors on
        the module's device. Returns (loss, est) detached; the pre-clip
        global gradient norm is `last_grad_norm`."""
        self.net.train()
        est = self.net(model_inputs)["output"]
        loss = self._loss(est, target)
        self.optimizer.zero_grad()
        loss.backward()
        self.last_grad_norm = self.optimizer.step()
        return loss.detach(), est.detach()

    @torch.no_grad()
    def val_step(self, model_inputs, target):
        self.net.eval()
        est = self.net(model_inputs)["output"]
        return self._loss(est, target), est

    def _step(self, batch, step="train"):
        inputs, targets = batch
        batch_size = inputs["mixture"].shape[0]
        model_inputs = self._model_inputs(inputs)
        gt = np.asarray(targets["target"], np.float32)
        target = torch.from_numpy(gt).to(self.device)
        run = self.train_step if step == "train" else self.val_step
        loss, est = run(model_inputs, target)

        mix = np.asarray(inputs["mixture"][:, 0:1])
        est_np = est.cpu().numpy()
        n_speakers = np.asarray(targets["num_target_speakers"])
        n_far = np.asarray(targets["num_interfering_speakers"])
        n_noises = np.asarray(targets.get("num_noises",
                                          np.zeros(batch_size, np.int64)))
        loss_f = float(loss)

        self.log_metric(f"{step}/loss", loss_f, batch_size=batch_size,
                        on_step=(step == "train"), on_epoch=True)
        for metric in self.metrics:
            # the host-side perceptual metrics are validation-only, as in
            # the JAX package
            if step == "train" and metric.name in ("PESQ", "STOI"):
                continue
            vals = np.asarray(metric(est=est_np, gt=gt, mix=mix))
            for i in range(batch_size):
                if n_speakers[i] > 0:
                    if not np.abs(gt[i]).max() > 0:
                        raise ValueError(
                            f"sample {i} has {int(n_speakers[i])} target "
                            "speaker(s) but an all-zero target")
                    self.log_metric(f"{step}/{metric.name}", vals[i])
                    if metric.name == "si_sdr_i":
                        self.log_metric(
                            f"{step}/{metric.name}_{int(n_speakers[i])}spk",
                            vals[i])
        decays = np.asarray(compute_decay(est_np, mix))
        for i in range(batch_size):
            if n_speakers[i] == 0:
                self.log_metric(f"{step}/decay", decays[i])

        key = f"stat/{step}_input_snr"
        if key not in self.statistics or not self.statistics[key]["logged"]:
            in_snr = np.asarray(self.snr_metric(est=mix, gt=gt, mix=mix))
            for i in range(batch_size):
                if n_speakers[i] > 0:
                    self.log_statistic(key, float(in_snr[i]),
                                       reduction="histogram")
                self.log_statistic(f"stat/{step}_num_tgt_speakers",
                                   int(n_speakers[i]), reduction="histogram")
                self.log_statistic(f"stat/{step}_num_far_speakers",
                                   int(n_far[i]), reduction="histogram")
                self.log_statistic(f"stat/{step}_num_noises",
                                   int(n_noises[i]), reduction="histogram")
        return loss_f, batch_size

    def training_step(self, batch, batch_idx=0):
        """One optimizer step on a (inputs, targets) numpy batch. Returns
        (loss, batch size)."""
        return self._step(batch, step="train")

    def validation_step(self, batch, batch_idx=0):
        return self._step(batch, step="val")

    def train(self):
        self.net.train()

    def eval(self):
        self.net.eval()

    def init_scheduler(self, scheduler, scheduler_params):
        if scheduler is None:
            return None
        if scheduler == "sequential":
            from sound_bubble_tpu_torch.train.optim import SequentialLR
            scheds, milestones = [], []
            for spec in scheduler_params:
                scheds.append(import_attr(spec["name"])(
                    self.optimizer, **spec["params"]))
                milestones.append(spec["epochs"])
            for i in range(1, len(milestones)):
                milestones[i] += milestones[i - 1]
            milestones.pop()
            return SequentialLR(self.optimizer, scheds, milestones)
        return import_attr(scheduler)(self.optimizer, **scheduler_params)

    @property
    def model(self):
        """Callable standing in for the reference's `pl_module.model`:
        `model(inputs, input_state=None, pad=True)` and `init_buffers`."""
        return ModelHandle(self)


class ModelHandle:
    def __init__(self, module: PLModule):
        self._module = module

    @property
    def cfg(self):
        return self._module.net.cfg

    def init_buffers(self, batch_size):
        return self._module.net.init_buffers(batch_size)

    @torch.no_grad()
    def __call__(self, inputs, input_state=None, pad=True):
        net = self._module.net.eval()
        return net(self._module._model_inputs(inputs), input_state, pad)
