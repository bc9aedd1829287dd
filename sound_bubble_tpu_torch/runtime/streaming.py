"""Streaming inference: the 8 ms-chunk loop over the model's own forward
(port of `sound_bubble_tpu/runtime/streaming.py`: `ModelWrapper`,
`streaming_inference`, `streaming_inference_scan`).

Mirrors the reference's `edge/causal_infer.py` (`ModelWrapper.feed` +
`streaming_inference`): the state is threaded through `Net.forward` chunk by
chunk. This is the model-level streaming path; `runtime/fast_path.py` runs
the same math with the block stack in one kernel launch per chunk.

`streaming_inference_scan` is the counterpart of the JAX package's
whole-signal `lax.scan`: on the card, one CUDA graph of a single chunk step
(the forward and the copy of its next state into the state it read),
captured once and replayed for each window; on the CPU the plain loop. Its
`dir_fuse` (JAX: the direction-fused BLSTM its scan is traced with) is row
5, the fused inference BLSTM (`Net.forward(..., pallas_blstm=True)`), for
that call only. A graph launches each captured kernel once a replay without
running the wrappers' Python, so the launch counters
(`ops/kernels.launch_counts`) count the capture once and are then set to
the capture's launches times the replays.
"""
from __future__ import annotations

import torch

from sound_bubble_tpu_torch.models.tfgridnet.model import init_state
from sound_bubble_tpu_torch.ops import kernels
from sound_bubble_tpu_torch.train.module import ModelHandle
from sound_bubble_tpu_torch.utils import resolve_device, to_tensor

DEFAULT_DIS_EMBED = [[0.0, 0.0, 1.0]]      # the 1 m bubble


class ModelWrapper:
    """Stateful streaming wrapper around a `Net` or a PLModule's `model`
    handle. `feed(mix)` threads the internal state across calls."""

    def __init__(self, mdl, device="cuda"):
        net = mdl._module.net if isinstance(mdl, ModelHandle) else mdl
        self.device = resolve_device(device)
        self.net = net.to(self.device).eval()
        self.cfg = net.cfg
        self.internal_state = None

    def eval(self):
        return self

    def reset(self):
        self.internal_state = None

    @torch.no_grad()
    def feed(self, mix, dis_embed=None, pad=False):
        """One chunk through the net, threading the state. `pad` is taken
        for the reference's signature and ignored: the net steps with
        pad=False, as the JAX package's wrapper does."""
        del pad
        mix = to_tensor(mix, self.device)
        if self.internal_state is None:
            self.internal_state = init_state(self.cfg, mix.shape[0],
                                             self.device)
        inputs = {"mixture": mix}
        if self.cfg.conditional:
            if dis_embed is None:
                dis_embed = DEFAULT_DIS_EMBED
            inputs["dis_embed"] = to_tensor(dis_embed, self.device)
        out = self.net(inputs, self.internal_state, False)
        self.internal_state = out["next_state"]
        return out["output"]


def streaming_inference(mdl: ModelWrapper, x, chunk_size: int,
                        pad_length: int, dis_embed=None):
    """Chunk-by-chunk rolling-window loop (reference semantics: the signal is
    n_chunks*chunk + pad samples; window = [past chunk tail | new chunk])."""
    x = to_tensor(x, mdl.device)
    num_samples = x.shape[-1]
    window = x.new_zeros((x.shape[0], x.shape[1], chunk_size + pad_length))
    if pad_length:
        window[..., -pad_length:] = x[..., :pad_length]
    outputs = []
    for i in range(pad_length, num_samples - chunk_size + 1, chunk_size):
        window = torch.roll(window, -chunk_size, dims=-1)
        window[..., -chunk_size:] = x[..., i:i + chunk_size]
        outputs.append(mdl.feed(window, dis_embed))
    return torch.cat(outputs, dim=-1)


def _copy_state(dst, src):
    """Copy the nested state dict src into dst's tensors, in place."""
    for key, value in src.items():
        if isinstance(value, dict):
            _copy_state(dst[key], value)
        else:
            dst[key].copy_(value)


def _graph_scan(net, windows, inputs, state, dir_fuse):
    """The windows through one captured chunk step, replayed per window."""
    static = {"mixture": windows[0].clone(), **inputs}

    def step():
        return net(static, state, pad=False, pallas_blstm=dir_fuse)

    # warm up on a side stream (builds the kernels, fills the allocator)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    before = kernels.launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
        _copy_state(state, out["next_state"])
    outputs = []
    for win in windows:
        static["mixture"].copy_(win)
        graph.replay()
        outputs.append(out["output"].clone())
    kernels.count_replays(before, len(windows))
    return torch.cat(outputs, dim=-1)


@torch.no_grad()
def streaming_inference_scan(net, x, chunk_size: int, pad_length: int,
                             dis_embed=None, dir_fuse: bool = True,
                             device="cuda"):
    """Whole-signal streaming of a `Net` over x [B, M, pad + n*chunk]:
    windows precomputed, chunks chained (numerically the chunk loop). On a
    CUDA device one CUDA graph of the chunk step, replayed per window; a
    capture that fails raises. `dir_fuse`: the intra BLSTMs on row 5 (the
    fused inference BLSTM) for this call. -> [B, S, n*chunk]."""
    device = resolve_device(device)
    net = net.to(device).eval()
    x = to_tensor(x, device)
    n_chunks = (x.shape[-1] - pad_length) // chunk_size
    windows = [x[..., k * chunk_size:k * chunk_size + chunk_size + pad_length]
               for k in range(n_chunks)]
    inputs = {}
    if net.cfg.conditional:
        inputs["dis_embed"] = to_tensor(
            DEFAULT_DIS_EMBED if dis_embed is None else dis_embed, device)
    state = init_state(net.cfg, x.shape[0], device)
    if device.type == "cuda":
        return _graph_scan(net, windows, inputs, state, dir_fuse)
    outputs = []
    for win in windows:
        out = net({"mixture": win, **inputs}, state, pad=False,
                  pallas_blstm=dir_fuse)
        state = out["next_state"]
        outputs.append(out["output"])
    return torch.cat(outputs, dim=-1)
