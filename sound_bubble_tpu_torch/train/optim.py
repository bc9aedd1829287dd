"""Optimizers and LR schedulers (port of `sound_bubble_tpu/train/optim.py`).

The JAX update is `clip_by_global_norm -> scale_by_adam -> x(-lr)`. Here:
- the clip is written out as optax computes it: with the global norm
  `n = sqrt(sum g^2)`, the gradients are left alone when `n < max_norm` and
  become `g / n * max_norm` otherwise (`torch.nn.utils.clip_grad_norm_`
  divides by `n + 1e-6` instead, so it is not used);
- the Adam and AdamW updates are PyTorch's `torch.optim.Adam` / `AdamW`,
  which give optax's update for the same gradients
  (`tests/test_torch_port_train.py` holds them to the JAX package);
- the LR is a host-side value that the epoch-level schedulers mutate, as in
  the JAX package; the schedulers are copies of its classes.
"""
from __future__ import annotations

import numpy as np
import torch


class Optimizer:
    """Host-side optimizer handle: a torch optimizer, the global-norm clip
    and a mutable `lr`. `step()` returns the pre-clip global norm."""

    def __init__(self, params, lr: float, grad_clip: float | None = None):
        self.params = [p for p in params if p.requires_grad]
        self.initial_lr = float(lr)
        self.grad_clip = grad_clip
        self.opt = self._make(self.params, float(lr))

    def _make(self, params, lr):
        raise NotImplementedError

    @property
    def lr(self) -> float:
        return self.opt.param_groups[0]["lr"]

    @lr.setter
    def lr(self, value: float):
        for group in self.opt.param_groups:
            group["lr"] = float(value)

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def global_norm(self) -> torch.Tensor:
        grads = [p.grad for p in self.params if p.grad is not None]
        return torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        norm = self.global_norm()
        if self.grad_clip is not None:
            # optax.clip_by_global_norm: g / n * max_norm once n >= max_norm
            scale = torch.where(norm < self.grad_clip,
                                torch.ones_like(norm),
                                self.grad_clip / norm)
            for p in self.params:
                if p.grad is not None:
                    p.grad.mul_(scale)
        self.opt.step()
        return norm

    def state_dict(self):
        """{"lr": float, "state": torch optimizer state with numpy arrays}:
        plain Python and numpy only, so a checkpoint holding it unpickles
        without torch."""
        return {"lr": self.lr, "state": _to_numpy(self.opt.state_dict())}

    def load_state_dict(self, sd):
        self.opt.load_state_dict(_to_torch(sd["state"]))
        self.lr = sd["lr"]


def _to_numpy(node):
    if isinstance(node, torch.Tensor):
        return node.detach().cpu().numpy()
    if isinstance(node, dict):
        return {k: _to_numpy(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_to_numpy(v) for v in node)
    return node


def _to_torch(node):
    if isinstance(node, np.ndarray):
        return torch.from_numpy(np.array(node))
    if isinstance(node, dict):
        return {k: _to_torch(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_to_torch(v) for v in node)
    return node


class Adam(Optimizer):
    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, grad_clip=None):
        self.betas, self.eps, self.weight_decay = tuple(betas), eps, \
            weight_decay
        super().__init__(params, lr, grad_clip)

    def _make(self, params, lr):
        return torch.optim.Adam(params, lr=lr, betas=self.betas, eps=self.eps,
                                weight_decay=self.weight_decay)


class AdamW(Adam):
    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=1e-2, grad_clip=None):
        super().__init__(params, lr, betas, eps, weight_decay, grad_clip)

    def _make(self, params, lr):
        return torch.optim.AdamW(params, lr=lr, betas=self.betas,
                                 eps=self.eps, weight_decay=self.weight_decay)


# ------------------------------------------------------------- schedulers ---

class _Scheduler:
    """Epoch-level scheduler mutating optimizer.lr (torch-like API)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.last_epoch = 0

    def step(self, metric=None):
        self.last_epoch += 1
        self._update(metric)

    def _update(self, metric):
        pass

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items() if k != "optimizer"}

    def load_state_dict(self, sd):
        self.__dict__.update(sd)


class ReduceLROnPlateau(_Scheduler):
    """torch semantics: rel-threshold 1e-4, cooldown 0."""

    def __init__(self, optimizer, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, min_lr=0.0, **_):
        super().__init__(optimizer)
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.min_lr = threshold, min_lr
        self.best = None
        self.num_bad_epochs = 0

    def _better(self, metric):
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best * (1 - self.threshold)
        return metric > self.best * (1 + self.threshold)

    def _update(self, metric):
        if metric is None:
            raise ValueError("ReduceLROnPlateau needs the monitored metric")
        metric = float(metric)
        if self._better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.optimizer.lr = max(self.optimizer.lr * self.factor,
                                    self.min_lr)
            self.num_bad_epochs = 0


class StepLR(_Scheduler):
    def __init__(self, optimizer, step_size, gamma=0.1, **_):
        super().__init__(optimizer)
        self.step_size, self.gamma = step_size, gamma

    def _update(self, metric):
        if self.last_epoch % self.step_size == 0:
            self.optimizer.lr *= self.gamma


class ExponentialLR(_Scheduler):
    def __init__(self, optimizer, gamma, **_):
        super().__init__(optimizer)
        self.gamma = gamma

    def _update(self, metric):
        self.optimizer.lr *= self.gamma


class ConstantLR(_Scheduler):
    """torch ConstantLR: lr * factor until total_iters epochs elapse."""

    def __init__(self, optimizer, factor=1.0 / 3, total_iters=5, **_):
        super().__init__(optimizer)
        self.factor, self.total_iters = factor, total_iters
        optimizer.lr = optimizer.initial_lr * factor

    def _update(self, metric):
        if self.last_epoch == self.total_iters:
            self.optimizer.lr = self.optimizer.initial_lr


class LinearLR(_Scheduler):
    def __init__(self, optimizer, start_factor=1.0 / 3, end_factor=1.0,
                 total_iters=5, **_):
        super().__init__(optimizer)
        self.start_factor, self.end_factor = start_factor, end_factor
        self.total_iters = total_iters
        optimizer.lr = optimizer.initial_lr * start_factor

    def _update(self, metric):
        t = min(self.last_epoch, self.total_iters)
        f = self.start_factor + (self.end_factor - self.start_factor) * (
            t / self.total_iters)
        self.optimizer.lr = self.optimizer.initial_lr * f


class SequentialLR(_Scheduler):
    """Composite with per-stage epoch milestones (reference `"sequential"`
    scheduler spec)."""

    def __init__(self, optimizer, schedulers, milestones):
        super().__init__(optimizer)
        self.schedulers = schedulers
        self.milestones = milestones

    def step(self, metric=None):
        idx = sum(self.last_epoch >= m for m in self.milestones)
        self.schedulers[idx].step(metric)
        self.last_epoch += 1

    def state_dict(self):
        return {"last_epoch": self.last_epoch,
                "milestones": self.milestones,
                "children": [s.state_dict() for s in self.schedulers]}

    def load_state_dict(self, sd):
        self.last_epoch = sd["last_epoch"]
        self.milestones = sd["milestones"]
        for s, child in zip(self.schedulers, sd["children"]):
            s.load_state_dict(child)
