"""Streaming inference: the 8 ms-chunk loop over the model's own forward
(port of `sound_bubble_tpu/runtime/streaming.py`: `ModelWrapper`,
`streaming_inference`).

Mirrors the reference's `edge/causal_infer.py` (`ModelWrapper.feed` +
`streaming_inference`): the state is threaded through `Net.forward` chunk by
chunk. This is the plain PyTorch streaming path; `runtime/fast_path.py` runs
the same math with the block stack in one kernel launch per chunk.
"""
from __future__ import annotations

import torch

from sound_bubble_tpu_torch.models.tfgridnet.model import init_state
from sound_bubble_tpu_torch.utils import resolve_device, to_tensor


class ModelWrapper:
    """Stateful streaming wrapper around a `Net`. `feed(mix)` threads the
    internal state across calls."""

    def __init__(self, net, device="cuda"):
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
        mix = to_tensor(mix, self.device)
        if self.internal_state is None:
            self.internal_state = init_state(self.cfg, mix.shape[0],
                                             self.device)
        inputs = {"mixture": mix}
        if self.cfg.conditional:
            if dis_embed is None:
                dis_embed = [[0.0, 0.0, 1.0]]
            inputs["dis_embed"] = to_tensor(dis_embed, self.device)
        out = self.net(inputs, self.internal_state, pad)
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
