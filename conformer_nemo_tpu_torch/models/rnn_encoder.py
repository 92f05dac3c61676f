"""The RNN (LSTM) encoder and the LSTM CTC head (port of
conformer_nemo_tpu/models/rnn_encoder.py).

    enc = RNNEncoder.create(RNNEncoderConfig(), device=None, seed=0)   # CUDA
    out, out_lens = enc(features, lengths)          # [B, 80, T] -> [B, 512, T / 4]
    head = LSTMDecoder.create(LSTMDecoderConfig(feat_in=512), device=enc_device)
    log_probs = head(out)                           # [B, T / 4, num_classes + 1]

RNNEncoder: a pre-encode (the conformer's conv subsampling modes, stacking,
or a linear layer at factor 1; the conformer's length rules), then per layer
a (bi)LSTM, a projection, a LayerNorm and dropout. LSTMDecoder: an LSTM
stack, a linear layer and log_softmax.

The LSTM layer is the JAX `_LSTMLayer`: fused gates (i, f, g, o) of width
4H with one bias `b`, a constant +1.0 on the forget gate, `wx` [D, 4H]
(xavier-uniform) and `wh` [H, 4H] (orthogonal) in the JAX layouts; the two
products in the compute dtype (`cfg.dtype`), summed there, then fp32; the
state in fp32; the reverse direction runs over the whole padded sequence
reversed, as the JAX scan does. Both directions step together (one batched
product a step); the input products are hoisted out of the time loop, which
the host drives, as the transducer's prediction network does. The front end's convolutions run
with cuDNN's TF32 off (models/conv_asr.py `fp32_convolutions`), so an fp32
encoder computes in fp32 on the card as on the CPU.
Submodules carry the flax names (`pre_encode`, `lstm{i}_fwd`, `lstm{i}_bwd`,
`proj{i}`, `norm{i}`, `fc`), so convert/jax_params.py bridges the weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from conformer_nemo_tpu_torch.models.conformer import (
    ConformerEncoderConfig,
    ConvSubsampling,
    StackingSubsampling,
    _linear,
    encoder_lengths,
    uses_conv_subsampling,
)
from conformer_nemo_tpu_torch.models.conv_asr import fp32_convolutions
from conformer_nemo_tpu_torch.models.rnnt import _dropout


@dataclasses.dataclass(frozen=True)
class RNNEncoderConfig:
    feat_in: int = 80
    n_layers: int = 4
    d_model: int = 512
    proj_size: int = -1  # -1 -> d_model
    rnn_type: str = "lstm"
    bidirectional: bool = True
    subsampling: str = "striding"
    subsampling_factor: int = 4
    subsampling_conv_channels: int = -1
    dropout: float = 0.2
    dtype: Any = torch.bfloat16

    @property
    def proj(self) -> int:
        return self.proj_size if self.proj_size > 0 else self.d_model


@dataclasses.dataclass(frozen=True)
class LSTMDecoderConfig:
    """NeMo's LSTMDecoder arguments."""

    feat_in: int = 512
    num_classes: int = 28  # without the blank, which the head adds
    lstm_hidden_size: int = 256
    bidirectional: bool = False
    num_layers: int = 1
    dtype: Any = torch.bfloat16


class LSTMLayer(nn.Module):
    """One direction of an LSTM layer: wx [D, 4H], wh [H, 4H], b [4H]."""

    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.wx = nn.Parameter(torch.zeros(d_in, 4 * hidden))
        self.wh = nn.Parameter(torch.zeros(hidden, 4 * hidden))
        self.b = nn.Parameter(torch.zeros(4 * hidden))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX initialisers: xavier-uniform wx, orthogonal wh, zero b."""
        nn.init.xavier_uniform_(self.wx, generator=generator)
        nn.init.orthogonal_(self.wh, generator=generator)
        self.b.zero_()


def run_lstm(layers: list, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x [B, T, D] through one layer's directions (`layers`: [forward] or
    [forward, backward]) -> [B, T, H * directions] fp32, the directions
    concatenated."""
    b, t, _ = x.shape
    h_size = layers[0].hidden
    xd = x.to(dtype)
    ig = [torch.matmul(xd, layer.wx.to(dtype)) for layer in layers]  # [B, T, 4H] each
    if len(layers) == 2:
        ig[1] = ig[1].flip(1)  # the backward direction reads the sequence reversed
    ig = torch.stack(ig)  # [dirs, B, T, 4H]
    wh = torch.stack([layer.wh.to(dtype) for layer in layers])  # [dirs, H, 4H]
    bias = torch.stack([layer.b for layer in layers])[:, None, :]  # [dirs, 1, 4H]
    h = torch.zeros((len(layers), b, h_size), device=x.device)
    c = torch.zeros_like(h)
    ys = []
    for step in range(t):
        z = (ig[:, :, step] + torch.bmm(h.to(dtype), wh)).float() + bias
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    y = torch.stack(ys, dim=2)  # [dirs, B, T, H]
    if len(layers) == 1:
        return y[0]
    return torch.cat([y[0], y[1].flip(1)], dim=-1)


def _init(module: nn.Module, seed: int) -> None:
    """The JAX package's initialisers from the seed: LeCun-normal linears
    and convolutions (api.py `init_weights`), the LSTMs' own."""
    from conformer_nemo_tpu_torch.api import init_weights

    gen = torch.Generator().manual_seed(seed)
    init_weights(module, gen)
    for mod in module.modules():
        if isinstance(mod, LSTMLayer):
            mod.reset_parameters(gen)


def pre_encode_config(cfg: RNNEncoderConfig) -> ConformerEncoderConfig:
    """The conformer config whose front end the RNN encoder takes (its
    d_model the projection width)."""
    return ConformerEncoderConfig(feat_in=cfg.feat_in, d_model=cfg.proj,
                                  subsampling=cfg.subsampling,
                                  subsampling_factor=cfg.subsampling_factor,
                                  subsampling_conv_channels=cfg.subsampling_conv_channels,
                                  dtype=cfg.dtype)


class RNNEncoder(nn.Module):
    """[B, D_feat, T] + lengths -> [B, proj, T'] (fp32) + lengths'."""

    def __init__(self, cfg: RNNEncoderConfig):
        super().__init__()
        if cfg.rnn_type != "lstm":
            raise ValueError(f"rnn_type {cfg.rnn_type!r}: lstm only, as the JAX encoder")
        self.cfg = cfg
        enc_cfg = pre_encode_config(cfg)
        self.enc_cfg = enc_cfg
        if cfg.subsampling == "stacking" and cfg.subsampling_factor > 1:
            self.pre_encode = StackingSubsampling(enc_cfg)
        elif cfg.subsampling_factor > 1:
            if not uses_conv_subsampling(enc_cfg):
                raise ValueError(f"unknown subsampling mode: {cfg.subsampling!r}")
            self.pre_encode = ConvSubsampling(enc_cfg)
        else:
            self.pre_encode = nn.Linear(cfg.feat_in, cfg.proj)
        d_in = cfg.proj
        for i in range(cfg.n_layers):
            self.add_module(f"lstm{i}_fwd", LSTMLayer(d_in, cfg.d_model))
            if cfg.bidirectional:
                self.add_module(f"lstm{i}_bwd", LSTMLayer(d_in, cfg.d_model))
            dirs = 2 if cfg.bidirectional else 1
            self.add_module(f"proj{i}", nn.Linear(dirs * cfg.d_model, cfg.proj))
            self.add_module(f"norm{i}", nn.LayerNorm(cfg.proj, eps=1e-6))  # flax's epsilon
            d_in = cfg.proj

    @classmethod
    def create(cls, cfg: RNNEncoderConfig, device=None, seed: int = 0) -> "RNNEncoder":
        """The encoder on `device` (None: CUDA, raising without a GPU), its
        weights drawn with the JAX package's initialisers from `seed`, in
        eval mode."""
        from conformer_nemo_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        module = cls(cfg)
        _init(module, seed)
        return module.to(dev).eval()

    def _directions(self, i: int) -> list:
        fwd = getattr(self, f"lstm{i}_fwd")
        return [fwd, getattr(self, f"lstm{i}_bwd")] if self.cfg.bidirectional else [fwd]

    def forward(self, features: torch.Tensor, lengths: torch.Tensor,
                dropout_seed: Optional[int] = None):
        """dropout_seed seeds the dropout masks in training mode (required
        there when cfg.dropout > 0); eval mode ignores it."""
        cfg = self.cfg
        gen = None
        if self.training and cfg.dropout > 0.0:
            if dropout_seed is None:
                raise ValueError("training mode with dropout needs a dropout_seed")
            gen = torch.Generator(device=features.device)
            gen.manual_seed(dropout_seed)
        x = features.transpose(1, 2)  # [B, T, F]
        if isinstance(self.pre_encode, nn.Linear):
            x = _linear(self.pre_encode, x, cfg.dtype)
        else:
            with fp32_convolutions():  # an fp32 front end in true fp32 on the card
                x, pre_stats = self.pre_encode(x)
            for bn, stats in pre_stats:
                bn.update_running_stats(stats)
        out_lengths = encoder_lengths(self.enc_cfg, lengths, features.shape[-1])
        x = x.to(torch.float32)
        for i in range(cfg.n_layers):
            y = run_lstm(self._directions(i), x, cfg.dtype)
            y = _linear(getattr(self, f"proj{i}"), y, cfg.dtype)
            y = getattr(self, f"norm{i}")(y.to(torch.float32))
            x = _dropout(y, cfg.dropout, gen)
        return x.transpose(1, 2), out_lengths


class LSTMDecoder(nn.Module):
    """The LSTM CTC head: [B, D, T] -> log-probs [B, T, num_classes + 1]."""

    def __init__(self, cfg: LSTMDecoderConfig):
        super().__init__()
        self.cfg = cfg
        d_in = cfg.feat_in
        for i in range(cfg.num_layers):
            self.add_module(f"lstm{i}_fwd", LSTMLayer(d_in, cfg.lstm_hidden_size))
            if cfg.bidirectional:
                self.add_module(f"lstm{i}_bwd", LSTMLayer(d_in, cfg.lstm_hidden_size))
            d_in = cfg.lstm_hidden_size * (2 if cfg.bidirectional else 1)
        self.fc = nn.Linear(d_in, cfg.num_classes + 1)

    @classmethod
    def create(cls, cfg: LSTMDecoderConfig, device=None, seed: int = 0) -> "LSTMDecoder":
        """As `RNNEncoder.create`."""
        from conformer_nemo_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        module = cls(cfg)
        _init(module, seed)
        return module.to(dev).eval()

    def forward(self, encoder_output: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = encoder_output.transpose(1, 2)  # [B, T, D]
        for i in range(cfg.num_layers):
            layers = [getattr(self, f"lstm{i}_fwd")]
            if cfg.bidirectional:
                layers.append(getattr(self, f"lstm{i}_bwd"))
            x = run_lstm(layers, x, cfg.dtype)
        logits = F.linear(x.to(torch.float32), self.fc.weight, self.fc.bias)
        return torch.log_softmax(logits, dim=-1)

