"""Single-stream low-latency streaming through the whole-stack kernel
(port of `sound_bubble_tpu/runtime/fast_path.py:FusedStreamer`).

`ModelWrapper` (runtime/streaming.py) runs the model's own forward, whose
block stack is ~B*(F+1) small LSTM cell steps (B*(F//s+1) for conv_lstm).
`FusedStreamer` runs the same math with the whole block stack in one kernel
launch per 8 ms chunk (`ops/kernels/stack_kernel.py`; CUDA source
`csrc/stack_walk.cu`, one cluster of 8 blocks a call, conv_lstm too); the
STFT, features, convs and iSTFT around it are plain PyTorch: the model's own
`encode` / `decode`, the look-back decode (`stft_back_pad > 0`) included,
which at T=1 is JAX's T=1 branch (the current frame's samples from
`stft_back_pad` on, the previous frame's last back+pad samples added onto
its first ones). On a CPU device the stack step runs its plain PyTorch
version.

Attention nets (`use_attn=True`) take one of JAX's two routes, chosen by
the constructor's `attn_in_kernel`:

- True (the default): the whole stack, attention included, in one launch
  of `gridnet_stack_step_attn` a chunk. The K/V rings are per-(head,
  channel) planes over W slots, `state["k_ring"]` [B, L*E, W, F] and
  `state["v_ring"]` [B, D, W, F], written in place at slot
  `state["attn_pos"]`, which advances as (pos + 1) % W. JAX gates this
  route on `attn_ring_bytes` < 10 MB, a limit of the TPU's VMEM, where its
  kernel keeps the rings. On the H100 the rings stay in global memory and
  the gate does not carry over: 13.9 MB at the flagship width and 5.57 MB
  at the Orange Pi width, both well inside the card's 50 MB L2, which is
  where the kernel's reads of them land.
- False: one launch of the non-attention stack step per block, on that
  block's slice of the pack, with the block's attention in plain PyTorch
  between launches on the model-layout `K_buf` / `V_buf` (the model's own
  `GridNetBlock.attend`). This is JAX's route at the flagship width; the
  port keeps it so that the two routes check each other on the card.

Float32 only: a net with the bf16 trunk raises NotImplementedError (bf16
serving, ROADMAP Queue 2 item 3) rather than being served in another
precision than its own.
"""
from __future__ import annotations

import torch

from sound_bubble_tpu_torch.models.tfgridnet.model import init_state
from sound_bubble_tpu_torch.ops.kernels.stack_kernel import (
    check_packed, gridnet_stack_step, gridnet_stack_step_attn,
    pack_attn_params, pack_stack_params)
from sound_bubble_tpu_torch.utils import resolve_device, to_tensor
from sound_bubble_tpu_torch.weights import param_tree


class FusedStreamer:
    """Stateful single-stream streaming wrapper (batch=1) on the fused
    kernel. `feed(window)` takes [1, M, back+chunk+pad] and returns
    [1, num_src, chunk], as ModelWrapper.feed does. `packed` (and
    `packed_attn` for an in-kernel attention net) holds the kernel's weight
    operands (checked once, here) and `film` the FiLM affines, on `device`.
    The inter-LSTM state is kept in the kernel's layout, `state["h0"]` /
    `state["c0"]` [B, F, H], in place of the model's per-block
    `gridnet_bufs`."""

    def __init__(self, net, dis_embed=None, device="cuda",
                 attn_in_kernel: bool = True):
        if net.cfg.compute_dtype == "bf16":
            raise NotImplementedError(
                "bf16 serving (the stack-step kernels in bf16) is not ported "
                "yet (ROADMAP Queue 2 item 3); serve the net with "
                "compute_dtype=None")
        self.device = resolve_device(device)
        self.net = net.to(self.device).eval()
        self.cfg = cfg = net.cfg
        tree = param_tree(net)
        self.packed = {k: v.to(self.device) for k, v in
                       pack_stack_params(cfg, tree).items()}
        self.attn_in_kernel = cfg.use_attn and attn_in_kernel
        self.packed_attn = None
        if self.attn_in_kernel:
            self.packed_attn = {k: v.to(self.device) for k, v in
                                pack_attn_params(cfg, tree).items()}
        check_packed(self.packed, self.device, self.packed_attn, cfg.L)
        # the per-block route: block i's slice of the pack ([1, ...], each
        # contiguous and checked with the pack)
        self.block_packs = None
        if cfg.use_attn and not attn_in_kernel:
            self.block_packs = [{k: v[i:i + 1] for k, v in
                                 self.packed.items()} for i in range(cfg.B)]
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
        F, W = cfg.n_freqs, cfg.local_atten_len
        state = init_state(cfg, 1, self.device)
        bufs = state.pop("gridnet_bufs")
        state["h0"] = torch.zeros((cfg.B, F, cfg.H), device=self.device)
        state["c0"] = torch.zeros_like(state["h0"])
        if self.attn_in_kernel:
            state["k_ring"] = torch.zeros((cfg.B, cfg.L * cfg.E, W, F),
                                          device=self.device)
            state["v_ring"] = torch.zeros((cfg.B, cfg.D, W, F),
                                          device=self.device)
            state["attn_pos"] = 0
        elif cfg.use_attn:
            state["attn"] = [{k: bufs[f"buf{i}"][k] for k in
                              ("K_buf", "V_buf")} for i in range(cfg.B)]
        return state

    def _stack(self, x, state, next_state, film):
        """The block stack on x [F, D] by the net's route; returns x'."""
        cfg = self.cfg
        fw, fb = film if film is not None else (None, None)
        if not cfg.use_attn:
            x, next_state["h0"], next_state["c0"] = gridnet_stack_step(
                self.packed, x, state["h0"], state["c0"], fw, fb,
                eps=cfg.eps, checked=True)
        elif self.attn_in_kernel:
            pos = state["attn_pos"]
            (x, next_state["h0"], next_state["c0"], next_state["k_ring"],
             next_state["v_ring"]) = gridnet_stack_step_attn(
                self.packed, self.packed_attn, x, state["h0"], state["c0"],
                state["k_ring"], state["v_ring"], pos, cfg.L, fw, fb,
                eps=cfg.eps, checked=True)
            next_state["attn_pos"] = (pos + 1) % cfg.local_atten_len
        else:
            hs, cs, attn = [], [], []
            for i, block in enumerate(self.net.blocks()):
                if i > 0 and fw is not None:
                    x = x * fw[i - 1] + fb[i - 1]
                x, h, c = gridnet_stack_step(
                    self.block_packs[i], x, state["h0"][i:i + 1],
                    state["c0"][i:i + 1], eps=cfg.eps, checked=True)
                buf = state["attn"][i]
                xa, k_buf, v_buf = block.attend(x[None, None], buf)
                x = xa[0, 0].contiguous()
                hs.append(h)
                cs.append(c)
                attn.append({"K_buf": k_buf, "V_buf": v_buf})
            next_state["h0"], next_state["c0"] = torch.cat(hs), torch.cat(cs)
            next_state["attn"] = attn
        return x

    def _step_impl(self, window, state, film):
        """window: [1, M, back+chunk+pad] -> (out [1, num_src, chunk],
        state')."""
        net = self.net
        next_state = dict(state)
        h, spec = net.encode(window, state, next_state)   # [1, 1, F, D]
        x = self._stack(h[0, 0].contiguous(), state, next_state, film)
        return net.decode(x[None, None], spec, state, next_state), next_state

    @torch.no_grad()
    def feed(self, window):
        window = to_tensor(window, self.device)
        if self.internal_state is None:
            self.internal_state = self._make_state()
        out, self.internal_state = self._step_impl(
            window, self.internal_state, self.film)
        return out
