"""Single-stream low-latency streaming through the whole-stack kernel
(port of `sound_bubble_tpu/runtime/fast_path.py:FusedStreamer`).

`ModelWrapper` (runtime/streaming.py) runs the model's own forward, whose
block stack is ~B*(F+1) small LSTM cell steps (B*(F//s+1) for conv_lstm).
`FusedStreamer` runs the same math with the whole block stack in one kernel
launch per 8 ms chunk (`ops/kernels/stack_kernel.py:gridnet_stack_step`, CUDA
source `csrc/stack_step.cu`: `stack_step_kernel_t<false>` for the plain intra
BLSTM, `<true>` for conv_lstm); the STFT, features, convs and iSTFT
around it are plain PyTorch. On a CPU device the stack step runs its plain
PyTorch version. Conditioned (FiLM) and unconditioned models; non-attention
configurations only (ROADMAP Queue 1 item 9); float32 only: a net with the
bf16 trunk raises NotImplementedError (bf16 serving, ROADMAP Queue 2 item 3)
rather than being served in another precision than its own.
"""
from __future__ import annotations

import torch

from sound_bubble_tpu_torch.models.tfgridnet.model import init_state
from sound_bubble_tpu_torch.ops.kernels.stack_kernel import (
    check_packed, gridnet_stack_step, pack_stack_params)
from sound_bubble_tpu_torch.utils import resolve_device, to_tensor
from sound_bubble_tpu_torch.weights import param_tree


class FusedStreamer:
    """Stateful single-stream streaming wrapper (batch=1) on the fused
    kernel. `feed(window)` takes [1, M, chunk+pad] and returns
    [1, num_src, chunk], as ModelWrapper.feed does. `packed` holds the
    kernel's weight operands (checked once, here) and `film` the FiLM
    affines, on `device`. The inter-LSTM state is kept in the kernel's
    layout, `state["h0"]`/`state["c0"]` [B, F, H], in place of the model's
    per-block `gridnet_bufs`."""

    def __init__(self, net, dis_embed=None, device="cuda"):
        if net.cfg.compute_dtype == "bf16":
            raise NotImplementedError(
                "bf16 serving (the stack-step kernels in bf16) is not ported "
                "yet (ROADMAP Queue 2 item 3); serve the net with "
                "compute_dtype=None")
        self.device = resolve_device(device)
        self.net = net.to(self.device).eval()
        self.cfg = net.cfg
        self.packed = {k: v.to(self.device) for k, v in pack_stack_params(
            self.cfg, param_tree(net)).items()}
        check_packed(self.packed, self.device)
        self.film = self._precompute_film(dis_embed)
        self.internal_state = None

    @torch.no_grad()
    def _precompute_film(self, dis_embed):
        """Per-block FiLM affines [B-1, F, D] x2 for a fixed distance
        embedding (None for unconditional models: no FiLM to apply)."""
        if not self.cfg.conditional or self.cfg.B < 2:
            return None
        if dis_embed is None:
            dis_embed = [[0.0, 0.0, 1.0]]
        dis_embed = to_tensor(dis_embed, self.device)
        emb = self.net.dis_embed(dis_embed)               # [1, F, d_in]
        affines = [film.affine(emb) for film in self.net.films()]
        return (torch.stack([w[0] for w, _ in affines]).contiguous(),
                torch.stack([b[0] for _, b in affines]).contiguous())

    def set_dis_embed(self, dis_embed):
        self.film = self._precompute_film(dis_embed)

    def reset(self):
        self.internal_state = None

    def _make_state(self):
        cfg = self.cfg
        state = init_state(cfg, 1, self.device)
        del state["gridnet_bufs"]
        state["h0"] = torch.zeros((cfg.B, cfg.n_freqs, cfg.H),
                                  device=self.device)
        state["c0"] = torch.zeros_like(state["h0"])
        return state

    def _step_impl(self, window, state, film):
        """window: [1, M, chunk+pad] -> (out [1, num_src, chunk], state')."""
        cfg, net = self.cfg, self.net
        next_state = dict(state)
        h, spec = net.encode(window, state, next_state)   # [1, 1, F, D]
        fw, fb = film if film is not None else (None, None)
        x, next_state["h0"], next_state["c0"] = gridnet_stack_step(
            self.packed, h[0, 0].contiguous(), state["h0"], state["c0"], fw,
            fb, eps=cfg.eps, checked=True)
        y = net.decode(x[None, None], spec, state, next_state)
        return y, next_state

    @torch.no_grad()
    def feed(self, window):
        window = to_tensor(window, self.device)
        if self.internal_state is None:
            self.internal_state = self._make_state()
        out, self.internal_state = self._step_impl(
            window, self.internal_state, self.film)
        return out
