"""Causal TF-GridNet with FiLM distance conditioning (port of
`sound_bubble_tpu/models/tfgridnet/model.py`).

Covers every field of the JAX `NetConfig`: the production configuration
(`syn_experiments/finetune_stage.json`, `runs/finetune_r5/config.json`: plain
intra BLSTM, `dis_type` conv3), the edge configurations
(`real_experiments/*.json`: `conv_lstm=True`, unconditioned), local causal
attention (`use_attn=True`, K/V buffers in the streaming state), the STFT
look-back decode (`stft_back_pad > 0`) and the linear `dis_type`s, in fp32 and
with the bf16 trunk (`compute_dtype="bf16"`). The bf16 trunk with attention
raises NotImplementedError (ROADMAP Queue 1). `remat` changes only memory
and is accepted and ignored.

The bf16 trunk follows the JAX package's mixed precision: the STFT, the
spatial features and the iSTFT run in float32; the features, the streaming
state and the distance embedding are cast to bf16; LayerNorm takes its
statistics in float32 and returns its input's dtype; convolutions follow the
activation dtype. Every product of two dtypes takes JAX's promotion
(bf16 x float32 -> float32; `ops.rnn.matmul`), since torch.matmul refuses
mixed operands: with float32 params (`train_pt --bf16`) the first Linear
after a bf16 activation returns float32, as in JAX; with bf16 params
(`cast_bf16`, `train_stream --bf16`) the trunk stays bf16.

Layouts follow the JAX package so the two compare array for array:
activations are channel-minor `[B, T, F, C]`; parameters keep the JAX names
and layouts (Linear `kernel` [in, out], conv `kernel` [kt, kf, in, out],
LSTM `w_ih` [C, 4H] / `w_hh` [H, 4H] / folded `b` [4H]), so a module's
`state_dict()` keys are the dotted paths of the JAX parameter tree
(`sound_bubble_tpu_torch/weights.py`). Weights start at zero: load them with
`net.load_state_dict(from_jax_params(tree))`, or draw them from a seed with
`net.init_weights(generator)` (the JAX package's initial distributions,
`ops/init.py`). `net_from_params` is the config system's model factory.

The streaming state is an explicit dict threaded through `forward`, with the
reference `init_buffers` key names (conv_buf / deconv_buf / istft_buf /
gridnet_bufs.bufN.{h0,c0,K_buf,V_buf}); offline and streaming share one
forward (streaming = the same call with T=1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as TF
from torch import nn

from sound_bubble_tpu_torch.constants import BUBBLE_RADII
from sound_bubble_tpu_torch.ops.features import spatial_features
from sound_bubble_tpu_torch.ops.init import lstm_init, uniform_fan
from sound_bubble_tpu_torch.ops.rnn import SCANS, blstm, lstm, matmul
from sound_bubble_tpu_torch.ops.stft import (
    STFT, istft, make_stft, mod_pad, stft)



@dataclasses.dataclass(frozen=True)
class NetConfig:
    """Mirrors the JAX `NetConfig` (reference `Net.__init__` kwargs)."""

    stft_chunk_size: int = 192
    stft_pad_size: int = 96
    stft_back_pad: int = 0
    num_ch: int = 6
    D: int = 32           # embedding dim
    B: int = 6            # number of GridNet blocks
    I: int = 1            # unused (kept for config parity)
    J: int = 1            # unused (kept for config parity)
    L: int = 4            # attention heads
    H: int = 64           # LSTM hidden
    E: int = 2            # per-head attention emb dim
    use_attn: bool = False
    lookahead: bool = True
    local_atten_len: int = 100
    chunk_causal: bool = True
    num_src: int = 1
    spectral_masking: bool = False
    use_first_ln: bool = False
    merge_method: str = "None"
    directional: bool = False
    conv_lstm: bool = True
    lstm_down: int = 4
    fb_type: str = "stft"
    dis_type: str = "conv3"
    conditional: bool = True
    eps: float = 1e-5
    # JAX rematerializes each block in the backward pass; here every
    # activation is kept (a memory choice only, the numbers are the same)
    remat: bool = True
    compute_dtype: str | None = None

    @property
    def n_fft(self) -> int:
        return self.stft_back_pad + self.stft_chunk_size + self.stft_pad_size

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def n_feat(self) -> int:
        n = 3 * (self.num_ch - 1)
        return n - 1 if self.directional else n

    @property
    def conv_in(self) -> int:
        if self.merge_method == "early_cat":
            return 2 * self.num_ch + self.n_feat
        return 2 * self.num_ch

    @property
    def istft_lookback(self) -> int:
        pad = self.n_fft - self.stft_chunk_size
        return 1 + (pad - 1) // pad

    @property
    def embed_width(self) -> int:
        return {"linear1": 1, "linear2": self.D, "conv1": 1, "conv2": 2,
                "conv3": 4, "conv4": 8}[self.dis_type]


def check_supported(cfg: NetConfig) -> None:
    """Raise for the one variant this port does not cover (the bf16 trunk
    with attention) and for an unknown `compute_dtype`."""
    if cfg.compute_dtype == "bf16" and cfg.use_attn:
        raise NotImplementedError(
            "the bf16 trunk with use_attn=True is not ported yet (ROADMAP "
            "Queue 1 item 15); train or serve an attention net in float32")
    if cfg.compute_dtype not in (None, "bf16"):
        raise ValueError(f"compute_dtype={cfg.compute_dtype!r}: None or "
                         "'bf16'")


def make_config(model_params: dict, conditional: bool = True) -> NetConfig:
    """NetConfig from a reference-style `model_params` JSON dict."""
    known = {f.name for f in dataclasses.fields(NetConfig)}
    kwargs = {k: v for k, v in model_params.items() if k in known}
    kwargs["conditional"] = conditional
    return NetConfig(**kwargs)


def init_state(cfg: NetConfig, batch_size: int, device="cpu",
               dtype=torch.float32) -> dict[str, Any]:
    """Zero streaming state (reference `init_buffers`, same key names)."""
    F, D = cfg.n_freqs, cfg.D

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def block_bufs():
        b = {"h0": zeros(batch_size, F, cfg.H),
             "c0": zeros(batch_size, F, cfg.H)}
        if cfg.use_attn:
            # the W-1 past frames of each head's keys and values
            w = cfg.local_atten_len - 1
            b["K_buf"] = zeros(batch_size, cfg.L, w, F * cfg.E)
            b["V_buf"] = zeros(batch_size, cfg.L, w, F * (D // cfg.L))
        return b

    return {
        "conv_buf": zeros(batch_size, 2, F, cfg.conv_in),
        "deconv_buf": zeros(batch_size, 2, F, D),
        "istft_buf": zeros(batch_size, cfg.num_src, cfg.istft_lookback, 2 * F),
        "gridnet_bufs": {f"buf{i}": block_bufs() for i in range(cfg.B)},
    }


# ---------------------------------------------------------------- layers ----

def _zeros(*shape):
    return nn.Parameter(torch.zeros(shape))


def _lstm_params(c, h):
    return nn.ParameterDict({"w_ih": _zeros(c, 4 * h), "w_hh": _zeros(h, 4 * h),
                             "b": _zeros(4 * h)})


@torch.no_grad()
def _init_lstm(p, generator):
    """JAX `init_lstm_params`: the two torch biases folded into one (the sum
    of two U(-1/sqrt(H), 1/sqrt(H)) draws)."""
    init = lstm_init(p["w_hh"].shape[0])
    p["w_ih"].copy_(init(p["w_ih"].shape, generator))
    p["w_hh"].copy_(init(p["w_hh"].shape, generator))
    p["b"].copy_(init(p["b"].shape, generator) + init(p["b"].shape, generator))


@torch.no_grad()
def _init_uniform(generator, fan_in, *params):
    for p in params:
        if p is not None:
            p.copy_(uniform_fan(p.shape, fan_in, generator))


class LayerNorm(nn.Module):
    """Affine LayerNorm over the trailing `dim` features."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.dim, self.eps = dim, eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = _zeros(dim)

    @torch.no_grad()
    def reset_parameters(self, generator):
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        # statistics in float32 under a bf16 trunk, output in x's dtype
        return TF.layer_norm(x.float(), (self.dim,), self.scale.float(),
                             self.bias.float(), self.eps).to(x.dtype)


class Linear(nn.Module):
    """`x @ kernel + bias` with the JAX layout kernel [in, out]."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True):
        super().__init__()
        self.kernel = _zeros(in_features, out_features)
        self.bias = _zeros(out_features) if use_bias else None

    def reset_parameters(self, generator):
        _init_uniform(generator, self.kernel.shape[0], self.kernel, self.bias)

    def forward(self, x):
        y = matmul(x, self.kernel)
        return y if self.bias is None else y + self.bias


class PReLU(nn.Module):
    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.tensor(0.25))

    @torch.no_grad()
    def reset_parameters(self, generator):
        self.alpha.fill_(0.25)

    def forward(self, x):
        # JAX promotes with the float32 slope (torch would keep x's dtype
        # for a 0-dim operand)
        dt = torch.promote_types(x.dtype, self.alpha.dtype)
        x = x.to(dt)
        return torch.clamp(x, min=0) + self.alpha.to(dt) * torch.clamp(x,
                                                                       max=0)


class CausalConv2d(nn.Module):
    """3x3 conv: valid over time (input pre-padded by the 2-frame state
    buffer), 'same' over frequency. x: [B, T+2, F, Cin] -> [B, T, F, Cout]."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = _zeros(3, 3, in_features, features)
        self.bias = _zeros(features)

    def reset_parameters(self, generator):
        kt, kf, cin, _ = self.kernel.shape
        _init_uniform(generator, kt * kf * cin, self.kernel, self.bias)

    def _conv(self, x, kernel):
        # follows the activation dtype; the bias is added after the
        # convolution, in that dtype, as in JAX
        y = TF.conv2d(x.permute(0, 3, 1, 2),
                      kernel.to(x.dtype).permute(3, 2, 0, 1), padding=(0, 1))
        return y.permute(0, 2, 3, 1) + self.bias.to(x.dtype)

    def forward(self, x):
        return self._conv(x, self.kernel)


class CausalDeconv2d(CausalConv2d):
    """ConvTranspose2d(k=3, padding=(2,1)) equivalent: a correlation with the
    double-flipped kernel, valid over (pre-buffered) time, same over freq."""

    def reset_parameters(self, generator):
        # torch ConvTranspose fan_in = out_ch * k * k
        kt, kf, _, cout = self.kernel.shape
        _init_uniform(generator, kt * kf * cout, self.kernel, self.bias)

    def forward(self, x):
        return self._conv(x, torch.flip(self.kernel, (0, 1)))


class DisEmbed(nn.Module):
    """Distance embedding: one-hot [B, 3] -> [B, F, D_in]. The conv
    dis_types normalise each frequency's D_in channels; linear1 normalises
    the F values of its one channel; linear2 projects to [D, F] (channel
    major) and normalises all F*D values together."""

    def __init__(self, cfg: NetConfig):
        super().__init__()
        self.kind = cfg.dis_type
        self.F, self.d_in = cfg.n_freqs, cfg.embed_width
        self.proj = Linear(len(BUBBLE_RADII), self.F * self.d_in,
                           use_bias=False)
        conv = self.kind.startswith("conv")
        self.norm = LayerNorm(self.d_in if conv else self.F * self.d_in)

    def forward(self, e):
        n = e.shape[0]
        if self.kind.startswith("conv"):
            return self.norm(self.proj(e).reshape(n, self.F, self.d_in))
        e = self.norm(self.proj(e))
        if self.kind == "linear1":
            return e[..., None]                           # [B, F, 1]
        return e.reshape(n, self.d_in, self.F).transpose(1, 2)


class FiLM(nn.Module):
    """Per-(freq, channel) scale+bias from the distance embedding."""

    def __init__(self, d_in: int, features: int):
        super().__init__()
        self.weight = Linear(d_in, features)
        self.bias = Linear(d_in, features)

    def affine(self, emb):
        """emb [B, F, D_in] -> (scale, bias) [B, F, C]."""
        return self.weight(emb), self.bias(emb)

    def forward(self, x, emb):
        w, b = self.affine(emb)
        return x * w[:, None] + b[:, None]


class IntraBand(nn.Module):
    """Sub-band module: bidirectional LSTM across frequency.

    conv_lstm=False: LN -> BLSTM over F -> Linear.
    conv_lstm=True: strided Conv1d down (k = F // s frames of stride s) ->
    PReLU -> LN -> BLSTM over k -> ConvTranspose1d up, zero-padded back to
    F rows (rows from k*s on get nothing, not even the bias).
    x: [B, T, F, C] -> [B, T, F, C] (residual added by the caller).
    `scan`: the BLSTM's kernel route (`ops.rnn.blstm`); `pallas_blstm`: the
    fused inference BLSTM (row 5) instead, unless a call says otherwise."""

    def __init__(self, cfg: NetConfig, scan: str = "slab",
                 pallas_blstm: bool = False):
        super().__init__()
        C, H = cfg.D, cfg.H
        self.scan = scan
        self.pallas_blstm = pallas_blstm
        self.conv_lstm, self.s = cfg.conv_lstm, cfg.lstm_down
        if cfg.conv_lstm:
            # Conv1d(C, C, kernel=s, stride=s) as a Linear over s*C; the JAX
            # model gives this LayerNorm the default eps (1e-5), not cfg.eps
            self.down = Linear(self.s * C, C)
            self.act = PReLU()
            self.norm = LayerNorm(C)
        else:
            self.norm = LayerNorm(C, eps=cfg.eps)
        self.blstm = nn.ModuleDict({"fwd": _lstm_params(C, H),
                                    "bwd": _lstm_params(C, H)})
        if cfg.conv_lstm:
            # ConvTranspose1d(2H, C, kernel=s, stride=s): [2H, s, C]
            self.up_kernel = _zeros(2 * H, self.s, C)
            self.up_bias = _zeros(C)
        else:
            self.proj = Linear(2 * H, C)

    def reset_parameters(self, generator):
        _init_lstm(self.blstm["fwd"], generator)
        _init_lstm(self.blstm["bwd"], generator)
        if self.conv_lstm:
            # torch ConvTranspose1d fan_in = out_ch * kernel
            C = self.up_bias.shape[0]
            _init_uniform(generator, C * self.s, self.up_kernel, self.up_bias)

    def forward(self, x, pallas_blstm=None):
        B, T, F, C = x.shape
        fused = self.pallas_blstm if pallas_blstm is None else pallas_blstm
        if not self.conv_lstm:
            z = self.norm(x).reshape(B * T, F, C)
            z = self.proj(blstm(self.blstm, z, scan=self.scan,
                                pallas_blstm=fused))
            return z.reshape(B, T, F, C)
        s = self.s
        k = F // s
        # non-overlapping stride-s framing of the first k*s rows
        z = x.reshape(B * T, F, C)[:, :k * s].reshape(B * T, k, s * C)
        z = self.norm(self.act(self.down(z)))
        z = blstm(self.blstm, z, scan=self.scan,
                  pallas_blstm=fused)                     # [BT, k, 2H]
        dt = torch.promote_types(z.dtype, self.up_kernel.dtype)
        z = torch.einsum("btH,Hsc->btsc", z.to(dt),
                         self.up_kernel.to(dt)) + self.up_bias
        z = TF.pad(z.reshape(B * T, k * s, C), (0, 0, 0, F - k * s))
        return z.reshape(B, T, F, C)


class AttnProj(nn.Module):
    """Q/K/V projection: Linear -> PReLU -> head split -> LayerNorm over the
    head's F*e values (the default eps, 1e-5, not cfg.eps, as in JAX).
    x: [B, T, F, C] -> [B, heads, T, F*e] (row f*e + j: frequency f,
    channel j of the head)."""

    def __init__(self, C: int, F: int, heads: int, e: int):
        super().__init__()
        self.heads, self.e = heads, e
        self.proj = Linear(C, heads * e)
        self.act = PReLU()
        self.norm = LayerNorm(F * e)

    def forward(self, x):
        B, T, F, _ = x.shape
        z = self.act(self.proj(x)).reshape(B, T, F, self.heads, self.e)
        z = z.permute(0, 3, 1, 2, 4).reshape(B, self.heads, T, F * self.e)
        return self.norm(z)


def local_attention(q, k_full, v_full, window):
    """Banded causal local attention (JAX `_local_attention`).

    q: [B, h, T, dk]; k_full/v_full: [B, h, T+W-1, d*] where index j holds
    frame j-(W-1); query t attends k_full[t .. t+W-1] (the W frames up to
    and including its own), scores scaled by 1/sqrt(dk) with dk = F*E.
    T <= W: one [T, T+W-1] score matrix with a band mask; T > W: queries in
    blocks of W (T padded up), block n attending the 2W-wide slab
    k_full[nW : nW+2W] with the band mask of each row. Masked scores are
    -1e9, as in JAX: a Python number, not a tensor made from one, which
    would copy from the host and so break a CUDA graph's capture of the
    streaming step. Returns [B, h, T, dv]."""
    B, h, T, dk = q.shape
    W = window
    scale = 1.0 / math.sqrt(dk)
    if T <= W:
        scores = torch.einsum("bhtd,bhjd->bhtj", q, k_full) * scale
        j = torch.arange(k_full.shape[2], device=q.device)[None, :]
        t = torch.arange(T, device=q.device)[:, None]
        mask = (j >= t) & (j <= t + W - 1)
        scores = torch.where(mask, scores, -1e9)
        return torch.einsum("bhtj,bhjd->bhtd", scores.softmax(dim=-1),
                            v_full)
    nb = -(-T // W)
    qb = TF.pad(q, (0, 0, 0, nb * W - T)).reshape(B, h, nb, W, dk)
    kv_len = nb * W + W            # the last block's slab ends at (nb+1)W

    def slabs(a):
        a = TF.pad(a, (0, 0, 0, kv_len - a.shape[2]))
        # [B, h, nb, 2W, d]: block n's rows nW .. nW+2W-1
        return a.unfold(2, 2 * W, W).transpose(-1, -2)

    k_slab, v_slab = slabs(k_full), slabs(v_full)
    scores = torch.einsum("bhnrd,bhnjd->bhnrj", qb, k_slab) * scale
    r = torch.arange(W, device=q.device)[:, None]
    j = torch.arange(2 * W, device=q.device)[None, :]
    mask = (j >= r) & (j <= r + W - 1)                  # W keys per row
    scores = torch.where(mask, scores, -1e9)
    out = torch.einsum("bhnrj,bhnjd->bhnrd", scores.softmax(dim=-1), v_slab)
    return out.reshape(B, h, nb * W, -1)[:, :, :T]


class GridNetBlock(nn.Module):
    """One TF-GridNet block: intra-frequency BLSTM + stateful inter-time
    LSTM + (use_attn) local causal attention over the past W frames. `scan`:
    the kernel route of both LSTMs (`ops.rnn`); `pallas_blstm`: the intra
    BLSTM's (`IntraBand`)."""

    def __init__(self, cfg: NetConfig, scan: str = "slab",
                 pallas_blstm: bool = False):
        super().__init__()
        C = cfg.D
        self.scan = scan
        self.intra = IntraBand(cfg, scan, pallas_blstm)
        self.inter_norm = LayerNorm(C, eps=cfg.eps)
        self.inter_lstm = _lstm_params(C, cfg.H)
        self.inter_proj = Linear(cfg.H, C)
        self.use_attn = cfg.use_attn
        if cfg.use_attn:
            F, L = cfg.n_freqs, cfg.L
            self.window = cfg.local_atten_len
            self.attn_q = AttnProj(C, F, L, cfg.E)
            self.attn_k = AttnProj(C, F, L, cfg.E)
            self.attn_v = AttnProj(C, F, L, C // L)
            self.attn_out_proj = Linear(C, C)
            self.attn_out_act = PReLU()
            # over the whole [F, C] frame, default eps as in JAX
            self.attn_out_norm = LayerNorm(F * C)

    def reset_parameters(self, generator):
        _init_lstm(self.inter_lstm, generator)

    def attend(self, x, state):
        """The attention section: x [B, T, F, C] and the block's K_buf /
        V_buf [B, L, W-1, F*e] -> (x + attention output, K_buf', V_buf').
        The output's channel l*vd + j is head l's value channel j."""
        B, T, F, C = x.shape
        W = self.window
        q, k, v = self.attn_q(x), self.attn_k(x), self.attn_v(x)
        k_full = torch.cat([state["K_buf"], k], dim=2)
        v_full = torch.cat([state["V_buf"], v], dim=2)
        heads = q.shape[1]
        o = local_attention(q, k_full, v_full, W)        # [B, L, T, F*vd]
        o = o.reshape(B, heads, T, F, C // heads).permute(0, 2, 3, 1, 4)
        o = self.attn_out_act(self.attn_out_proj(o.reshape(B, T, F, C)))
        o = self.attn_out_norm(o.reshape(B, T, F * C)).reshape(B, T, F, C)
        return (x + o, k_full[:, :, -(W - 1):], v_full[:, :, -(W - 1):])

    def forward(self, x, state, pallas_blstm=None):
        x = x + self.intra(x, pallas_blstm)
        z = self.inter_norm(x).transpose(1, 2)            # [B, F, T, C]
        z, (hT, cT) = lstm(self.inter_lstm, z, state["h0"], state["c0"],
                           scan=self.scan)
        x = x + self.inter_proj(z).transpose(1, 2)
        new_state = {"h0": hT, "c0": cT}
        if self.use_attn:
            x, new_state["K_buf"], new_state["V_buf"] = self.attend(x, state)
        return x, new_state


class Net(nn.Module):
    """Reference `Net` wrapper: mod-pad + TFGridNet core.

    forward(inputs, input_state=None, pad=True, pallas_blstm=None) ->
    {'output', 'next_state'} with inputs = {'mixture': [B, M, N],
    'dis_embed': [B, 3]} (dis_embed ignored when cfg.conditional is False).
    `lstm_scan`: the kernel route of every LSTM scan ("slab" or "seq",
    `ops.rnn`), handed to each block. `pallas_blstm`: every intra BLSTM on
    the fused inference kernel (row 5; inference only, float32), the JAX
    package's `SB_PALLAS_BLSTM=1`; a forward's `pallas_blstm` other than
    None overrides it for that call."""

    def __init__(self, cfg: NetConfig, lstm_scan: str = "slab",
                 pallas_blstm: bool = False):
        super().__init__()
        check_supported(cfg)
        if lstm_scan not in SCANS:
            raise ValueError(f"lstm_scan={lstm_scan!r}: one of {SCANS}")
        self.cfg = cfg
        self.lstm_scan = lstm_scan
        self.pallas_blstm = pallas_blstm
        if cfg.conditional:
            self.dis_embed = DisEmbed(cfg)
        self.conv = CausalConv2d(cfg.conv_in, cfg.D)
        if cfg.use_first_ln:
            self.first_ln = LayerNorm(cfg.D)
        for i in range(cfg.B):
            self.add_module(f"block{i}",
                            GridNetBlock(cfg, lstm_scan, pallas_blstm))
            if i > 0 and cfg.conditional:
                self.add_module(f"film{i - 1}",
                                FiLM(cfg.embed_width, cfg.D))
        self.deconv = CausalDeconv2d(cfg.D, cfg.num_src * 2)
        # the STFT filterbank moves with the module (not part of its weights)
        fb = make_stft(cfg.n_fft, cfg.stft_chunk_size)
        self.register_buffer("stft_filters", fb.filters, persistent=False)

    def init_weights(self, generator: torch.Generator):
        """Draw every weight from `generator` with the JAX package's initial
        distributions (PyTorch's defaults, `ops/init.py`)."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        return self

    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.cfg.B)]

    def films(self):
        return [getattr(self, f"film{i}") for i in range(self.cfg.B - 1)]

    def filterbank(self) -> STFT:
        cfg = self.cfg
        return STFT(cfg.n_fft, cfg.n_fft, cfg.stft_chunk_size,
                    self.stft_filters)

    def init_buffers(self, batch_size):
        p = next(self.parameters())
        return init_state(self.cfg, batch_size, p.device, self.trunk_dtype())

    def trunk_dtype(self, dtype=torch.float32):
        """bf16 under `compute_dtype="bf16"`, else `dtype` (the input's)."""
        return torch.bfloat16 if self.cfg.compute_dtype == "bf16" else dtype

    def forward(self, inputs, input_state=None, pad=True, pallas_blstm=None):
        cfg = self.cfg
        x = inputs["mixture"]
        if input_state is None:
            input_state = init_state(cfg, x.shape[0], x.device,
                                     self.trunk_dtype(x.dtype))
        mod = 0
        if pad:
            psz = ((cfg.stft_back_pad, cfg.stft_pad_size)
                   if cfg.lookahead else (0, 0))
            x, mod = mod_pad(x, cfg.stft_chunk_size, psz)
        emb = None
        if cfg.conditional:
            emb = self.dis_embed(inputs["dis_embed"]).to(
                self.trunk_dtype(x.dtype))
        fused = self.pallas_blstm if pallas_blstm is None else pallas_blstm
        y, next_state = self.core(x, emb, input_state, fused)
        if mod:
            y = y[..., :-mod]
        return {"output": y, "next_state": next_state}

    def encode(self, x, state, next_state):
        """STFT -> features -> causal conv. x: [B, M, N] ->
        (h [B, T, F, D], spec [B, M, T, 2F])."""
        cfg = self.cfg
        F = cfg.n_freqs
        # the STFT and the features in float32 (a bf16 trunk starts after)
        spec = stft(self.filterbank(), x.float())         # [B, M, T, 2F]
        real, imag = spec[..., :F], spec[..., F:]
        feat = torch.movedim(torch.cat([real, imag], dim=1), 1, -1)
        if cfg.merge_method == "early_cat":
            feat = torch.cat(
                [feat, spatial_features(real, imag, cfg.directional)], dim=-1)
        feat = feat.to(self.trunk_dtype(x.dtype))
        full = torch.cat([state["conv_buf"], feat], dim=1)
        next_state["conv_buf"] = full[:, -2:]
        h = self.conv(full)                               # [B, T, F, D]
        if cfg.use_first_ln:
            h = self.first_ln(h)
        return h, spec

    def decode(self, h, spec, state, next_state):
        """Causal deconv -> overlap-add iSTFT. h: [B, T, F, D] ->
        [B, num_src, T*chunk]."""
        cfg = self.cfg
        B, T, F, _ = h.shape
        full = torch.cat([state["deconv_buf"], h], dim=1)
        next_state["deconv_buf"] = full[:, -2:]
        # the iSTFT back-end in float32
        out = self.deconv(full).float().reshape(B, T, F, cfg.num_src, 2)
        est = torch.cat([out[..., 0].permute(0, 3, 1, 2),
                         out[..., 1].permute(0, 3, 1, 2)], dim=-1)
        if cfg.spectral_masking:
            est = est * spec[:, :cfg.num_src]
        full_spec = torch.cat([state["istft_buf"], est], dim=2)
        # the carried state keeps its dtype
        next_state["istft_buf"] = full_spec[:, :, -cfg.istft_lookback:].to(
            state["istft_buf"].dtype)
        chunk = cfg.stft_chunk_size
        if cfg.stft_back_pad == 0:
            y = istft(self.filterbank(), full_spec)
            y = y[..., :-(cfg.n_fft - chunk)]
        else:
            y = self._lookback_decode(full_spec)
        return y[..., cfg.istft_lookback * chunk:]

    def _lookback_decode(self, full_spec):
        """The look-back synthesis (JAX `_core`, reference
        `causal_decoder`): each frame's samples from `stft_back_pad` on, the
        previous frame's last back+pad samples added onto its head, the
        first `chunk` samples kept. [B, S, T', 2F] -> [B, S, T'*chunk]."""
        cfg = self.cfg
        chunk, la = cfg.stft_chunk_size, cfg.n_fft - cfg.stft_chunk_size
        B, S, Tp, _ = full_spec.shape
        frames = (full_spec @ self.stft_filters)[..., cfg.stft_back_pad:]
        prev_tail = TF.pad(frames[:, :, :-1, -la:], (0, 0, 1, 0))
        frames = frames + TF.pad(prev_tail, (0, frames.shape[-1] - la))
        return frames[..., :chunk].reshape(B, S, Tp * chunk)

    def core(self, x, emb, state, pallas_blstm=None):
        next_state = dict(state)
        h, spec = self.encode(x, state, next_state)
        bufs = {}
        for i, block in enumerate(self.blocks()):
            if i > 0 and emb is not None:
                h = self.films()[i - 1](h, emb)
            h, bufs[f"buf{i}"] = block(h, state["gridnet_bufs"][f"buf{i}"],
                                       pallas_blstm)
        next_state["gridnet_bufs"] = bufs
        return self.decode(h, spec, state, next_state), next_state


def net_from_params(lstm_scan: str = "slab", pallas_blstm: bool = False,
                    **model_params) -> Net:
    """Config-system entry point: the distance-conditioned production model
    (JAX `net_from_params`), its scans on the route `lstm_scan`, its intra
    BLSTMs on row 5 when `pallas_blstm`. Its weights are zeros until
    `init_weights` or `load_state_dict`."""
    return Net(make_config(model_params, conditional=True), lstm_scan,
               pallas_blstm)


def net_optim_from_params(lstm_scan: str = "slab", pallas_blstm: bool = False,
                          **model_params) -> Net:
    """Config-system entry point: the unconditioned edge variant."""
    return Net(make_config(model_params, conditional=False), lstm_scan,
               pallas_blstm)
