"""Single-stream low-latency streaming through the whole-stack kernel
(port of `sound_bubble_tpu/runtime/fast_path.py`: `FusedStreamer` and
`fused_scan_stream`).

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
  `state["attn_pos"]`, an int32 [1] tensor on the device (as in JAX's
  state) that the step advances there as (pos + 1) % W. JAX gates this
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

On the card the step is one CUDA graph, the counterpart of JAX's one jitted
dispatch a chunk: the first `feed` runs the step eagerly on a side stream
(the warm-up: it builds the kernels and fills the allocator) and then
captures it once, on a static window and the state's own tensors, with the
step's next state copied into them in place. Every later `feed` copies its
window in, replays the graph and returns a clone of the static output. So
the state stays in place on the device: `reset()` zeroes it there and
`set_dis_embed()` writes the new FiLM affines into the captured tensors. A
window of another shape captures anew. A capture that fails raises; nothing
falls back to the eager step on the card. All three routes capture (rows 1
and 2; rows 3 and 4 with the ring slot read from the device; the per-block
route, whose attention shifts its K/V buffers with `torch.cat`), the
look-back decode too. On the CPU, which runs only when asked, `feed` runs
the eager step (`_step_impl`) on the plain stack step. A graph runs no
Python when it replays, so the launch counters (`ops/kernels`) read what
the graph's launches would have counted run eagerly: the capture's count is
taken back and added once a replay.

`fused_scan_stream` is JAX's whole-signal harness (one `lax.scan`
dispatch): on the card one streamer's graph, captured at the first window
and replayed for each other one into an output allocated once, with no host
sync between chunks.

Float32 only: a net with the bf16 trunk raises NotImplementedError (bf16
serving, ROADMAP Queue 2 item 3) rather than being served in another
precision than its own.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from sound_bubble_tpu_torch.models.tfgridnet.model import init_state
from sound_bubble_tpu_torch.ops import kernels
from sound_bubble_tpu_torch.ops.kernels.stack_kernel import (
    check_packed, gridnet_stack_step, gridnet_stack_step_attn,
    pack_attn_params, pack_stack_params)
from sound_bubble_tpu_torch.runtime.streaming import _copy_state
from sound_bubble_tpu_torch.utils import resolve_device, to_tensor
from sound_bubble_tpu_torch.weights import param_tree


class _Captured(NamedTuple):
    """A captured step: its graph, static window and static output, and
    the launches of one replay (`kernels.capture_launches`)."""
    graph: object
    window: torch.Tensor
    out: torch.Tensor
    launches: dict


class FusedStreamer:
    """Stateful single-stream streaming wrapper (batch=1) on the fused
    kernel. `feed(window)` takes [1, M, back+chunk+pad] and returns
    [1, num_src, chunk], as ModelWrapper.feed does. `packed` (and
    `packed_attn` for an in-kernel attention net) holds the kernel's weight
    operands (checked once, here) and `film` the FiLM affines, on `device`.
    The inter-LSTM state is kept in the kernel's layout, `state["h0"]` /
    `state["c0"]` [B, F, H], in place of the model's per-block
    `gridnet_bufs`. On the card `feed` replays one captured graph of the
    step (module docstring)."""

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
        self._captured = None

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
        """New FiLM affines, copied into the tensors a captured step
        reads."""
        film = self._precompute_film(dis_embed)
        if self.film is None:
            self.film = film
        else:
            for dst, src in zip(self.film, film):
                dst.copy_(src)

    def reset(self):
        """Zero the state in place, so that a captured step stays valid."""
        if self.internal_state is not None:
            _copy_state(self.internal_state, self._make_state())

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
            state["attn_pos"] = torch.zeros((1,), dtype=torch.int32,
                                            device=self.device)
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

    def _advance(self, window):
        """One step on the state (made at the first); its output. On the
        card that is the graph's static output, which the next step
        overwrites."""
        if self.internal_state is None:
            self.internal_state = self._make_state()
        if self.device.type != "cuda":
            out, self.internal_state = self._step_impl(
                window, self.internal_state, self.film)
            return out
        cap = self._captured
        if cap is None or cap.window.shape != window.shape:
            return self._capture(window)
        cap.window.copy_(window)
        cap.graph.replay()
        kernels.add_launches(cap.launches)
        return cap.out

    def _capture(self, window):
        """The step on `window`, run eagerly on a side stream (the warm-up;
        its launches count), then captured for the next windows of its
        shape. Returns the eager step's output."""
        state, film = self.internal_state, self.film
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out, next_state = self._step_impl(window, state, film)
            _copy_state(state, next_state)
        main.wait_stream(side)
        out.record_stream(main)
        static = window.clone()
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out, next_state = self._step_impl(static, state, film)
            _copy_state(state, next_state)
        self._captured = _Captured(graph, static, static_out,
                                   kernels.capture_launches(before))
        return out

    @torch.no_grad()
    def feed(self, window):
        out = self._advance(to_tensor(window, self.device))
        return out.clone() if self.device.type == "cuda" else out


@torch.no_grad()
def fused_scan_stream(net, windows, dis_embed=None, device="cuda",
                      attn_in_kernel: bool = True):
    """Whole-signal fused streaming (JAX `fused_scan_stream`, the
    single-stream measurement harness): windows [n_chunks, 1, M,
    back+chunk+pad] chained through one `FusedStreamer`'s step -> [1,
    num_src, n_chunks*chunk]. The net carries its weights. On the card the
    step is captured at the first window and replayed for each other one
    into the output, allocated once, with no host sync between chunks; on
    the CPU the eager step runs in a loop."""
    fs = FusedStreamer(net, dis_embed, device, attn_in_kernel)
    windows = to_tensor(windows, fs.device)
    chunk = fs.cfg.stft_chunk_size
    out = windows.new_empty((1, fs.cfg.num_src, windows.shape[0] * chunk))
    for i, window in enumerate(windows):
        out[..., i * chunk:(i + 1) * chunk] = fs._advance(window)
    return out
