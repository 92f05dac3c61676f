"""SSL pretraining modules: the reconstruction decoder, the Gumbel vector
quantizer and the wav2vec 2.0 feature encoder (port of
conformer_nemo_tpu/models/ssl.py).

- `ReconstructionDecoder`: 1x1 projection -> [stride layers: act -> a
  stride-2 transposed convolution -> 1x1 -> BatchNorm] -> [non-stride
  layers: act -> depthwise conv -> 1x1 -> BatchNorm] -> act -> 1x1 to
  feat_out. Upsamples encoder frames by 2^stride_layers.
- `GumbelVectorQuantizer`: per-group logits -> Gumbel-softmax
  straight-through codeword selection, the codebook perplexity
  regulariser; `gumbel_temperature` gives the decayed temperature.
- `ConvFeatureEncoder`: seven strided convolutions over the raw waveform.

Submodules carry the JAX package's flax names (`in_proj`, `up0`,
`up0_proj`, `up0_bn`, `weight_proj`, `vars`, `conv0`, `ln0`, ...), so
convert/jax_params.py maps the trees leaf for leaf. BatchNorm is flax's
(momentum 0.9, eps 1e-3, biased running variance): the port's training
BatchNorm from models/conformer.py, whose running statistics are updated
once per forward here.

The transposed convolution is flax's `ConvTranspose(strides=2,
padding="SAME")`, which does not flip its kernel: the input is dilated by
the stride (zeros between frames), padded by (ceil((k + s - 2) / 2),
floor(...)) for k > s - 1, and cross-correlated with the kernel as it is.
The output has s * T frames. `torch.nn.ConvTranspose1d` flips the kernel
and pads symmetrically, so the port convolves the dilated input instead;
the weight keeps a Conv1d's [out, in, k] layout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from conformer_nemo_tpu_torch.models.conformer import BatchNorm, _linear


def batch_norm(bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Apply the port's BatchNorm to [B, C, ...] and, in training mode,
    update its running statistics at once (no recomputation here)."""
    y, stats = bn(x)
    if stats is not None:
        bn.update_running_stats(stats)
    return y


def activation(name: str):
    """flax's activation by name (`nn.relu`, `nn.gelu` with the tanh
    approximation, `nn.swish`/`silu`, `nn.tanh`)."""
    return {"relu": F.relu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "swish": F.silu, "silu": F.silu, "tanh": torch.tanh}[name]


def conv_transpose_same(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                        stride: int) -> torch.Tensor:
    """flax `ConvTranspose(strides=(s,), padding="SAME")` of x [B, C, T] with
    a Conv1d-layout weight [out, in, k] (not flipped) -> [B, out, s * T]."""
    b, c, t = x.shape
    k = weight.shape[-1]
    dilated = x.new_zeros((b, c, (t - 1) * stride + 1))
    dilated[:, :, ::stride] = x
    pad_len = k + stride - 2
    pad_a = k - 1 if stride > k - 1 else int(math.ceil(pad_len / 2))
    dilated = F.pad(dilated, (pad_a, pad_len - pad_a))
    return F.conv1d(dilated, weight, bias)


@dataclasses.dataclass(frozen=True)
class ReconstructionDecoderConfig:
    feat_in: int = 256
    feat_out: int = 80
    feat_hidden: int = 128
    stride_layers: int = 2
    non_stride_layers: int = 0
    kernel_size: int = 11
    activation: str = "relu"
    dtype: Any = torch.bfloat16


class ReconstructionDecoder(nn.Module):
    """[B, T_enc, feat_in] -> [B, T_enc * 2^stride_layers, feat_out] (fp32)."""

    def __init__(self, cfg: ReconstructionDecoderConfig):
        super().__init__()
        if (cfg.stride_layers + cfg.non_stride_layers) > 0 and (
                cfg.kernel_size < 3 or cfg.kernel_size % 2 == 0):
            raise ValueError("kernel_size must be >= 3 and odd with conv layers")
        self.cfg = cfg
        h, k = cfg.feat_hidden, cfg.kernel_size
        self.in_proj = nn.Linear(cfg.feat_in, h)
        for i in range(cfg.stride_layers):
            self.add_module(f"up{i}", nn.Conv1d(h, h, k))
            self.add_module(f"up{i}_proj", nn.Linear(h, h))
            self.add_module(f"up{i}_bn", BatchNorm(h, eps=1e-3))
        for i in range(cfg.non_stride_layers):
            self.add_module(f"conv{i}", nn.Conv1d(h, h, k, padding=k // 2, groups=h))
            self.add_module(f"conv{i}_proj", nn.Linear(h, h))
            self.add_module(f"conv{i}_bn", BatchNorm(h, eps=1e-3))
        self.out_proj = nn.Linear(h, cfg.feat_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        act = activation(cfg.activation)
        h = _linear(self.in_proj, x, dt)  # [B, T, H]
        for i in range(cfg.stride_layers):
            conv = getattr(self, f"up{i}")
            y = conv_transpose_same(act(h).transpose(1, 2).to(dt), conv.weight.to(dt),
                                    conv.bias.to(dt), 2)
            h = _linear(getattr(self, f"up{i}_proj"), y.transpose(1, 2), dt)
            h = batch_norm(getattr(self, f"up{i}_bn"), h.transpose(1, 2)).transpose(1, 2).to(dt)
        for i in range(cfg.non_stride_layers):
            conv = getattr(self, f"conv{i}")
            y = F.conv1d(act(h).transpose(1, 2).to(dt), conv.weight.to(dt), conv.bias.to(dt),
                         padding=conv.padding, groups=conv.groups)
            h = _linear(getattr(self, f"conv{i}_proj"), y.transpose(1, 2), dt)
            h = batch_norm(getattr(self, f"conv{i}_bn"), h.transpose(1, 2)).transpose(1, 2).to(dt)
        return _linear(self.out_proj, act(h), torch.float32)


@dataclasses.dataclass(frozen=True)
class ConvFeatureEncoderConfig:
    """wav2vec 2.0 base: 7 strided conv blocks over raw waveform, total
    stride 320; (dim, kernel, stride) per block."""

    conv_layers: tuple = (
        (512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 3, 2),
        (512, 2, 2), (512, 2, 2))
    extractor_mode: str = "layer_norm"  # layer_norm | group_norm
    conv_bias: bool = False
    normalize_audio: bool = True
    dtype: Any = torch.bfloat16


class ConvFeatureEncoder(nn.Module):
    """Raw waveform [B, T] + lengths -> features [B, C, T'] + lengths.
    `layer_norm` mode norms every block over channels; `group_norm` norms
    block 0 only, one group a channel (over time). flax's norms: eps 1e-6;
    GELU with the tanh approximation."""

    def __init__(self, cfg: ConvFeatureEncoderConfig):
        super().__init__()
        self.cfg = cfg
        c_in = 1
        for i, (dim, k, stride) in enumerate(cfg.conv_layers):
            self.add_module(f"conv{i}", nn.Conv1d(c_in, dim, k, stride=stride,
                                                  bias=cfg.conv_bias))
            if cfg.extractor_mode == "layer_norm":
                self.add_module(f"ln{i}", nn.LayerNorm(dim, eps=1e-6))
            elif cfg.extractor_mode == "group_norm" and i == 0:
                self.gn0 = nn.GroupNorm(dim, dim, eps=1e-6)
            c_in = dim

    def forward(self, waveform: torch.Tensor, lengths: torch.Tensor) -> tuple:
        cfg = self.cfg
        x = waveform.to(torch.float32)
        out_lens = lengths.to(torch.int64)
        if cfg.normalize_audio:
            mask = torch.arange(x.shape[1], device=x.device)[None, :] < out_lens[:, None]
            denom = torch.clamp(out_lens.to(torch.float32), min=1.0)[:, None]
            mean = torch.where(mask, x, 0.0).sum(1, keepdim=True) / denom
            var = torch.where(mask, (x - mean) ** 2, 0.0).sum(1, keepdim=True) / denom
            x = torch.where(mask, (x - mean) / torch.sqrt(var + 1e-5), 0.0)
        h = x[:, None, :]  # [B, 1, T]
        for i, (dim, k, stride) in enumerate(cfg.conv_layers):
            conv = getattr(self, f"conv{i}")
            bias = None if conv.bias is None else conv.bias.to(cfg.dtype)
            h = F.conv1d(h.to(cfg.dtype), conv.weight.to(cfg.dtype), bias,
                         stride=stride).to(torch.float32)
            if cfg.extractor_mode == "layer_norm":
                h = getattr(self, f"ln{i}")(h.transpose(1, 2)).transpose(1, 2)
            elif cfg.extractor_mode == "group_norm" and i == 0:
                h = self.gn0(h)
            h = F.gelu(h, approximate="tanh")
            out_lens = torch.div(out_lens - k, stride, rounding_mode="floor") + 1
        return h, torch.clamp(out_lens, min=0).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class GumbelVQConfig:
    dim: int = 320  # input channels
    num_vars: int = 320  # codewords per group
    groups: int = 2
    combine_groups: bool = True
    vq_dim: int = 128  # output dim
    temp_start: float = 2.0
    temp_min: float = 0.5
    temp_decay: float = 0.999995


def gumbel_temperature(cfg: GumbelVQConfig, step) -> float:
    """max(start * decay^step, min), in float32 as the JAX package computes it."""
    t = torch.tensor(cfg.temp_start, dtype=torch.float32) * torch.tensor(
        cfg.temp_decay, dtype=torch.float32) ** torch.tensor(float(step), dtype=torch.float32)
    return float(torch.clamp(t, min=cfg.temp_min))


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(U)) with U in [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device) * (1.0 - tiny) + tiny
    return -torch.log(-torch.log(u))


class GumbelVectorQuantizer(nn.Module):
    """x [B, T, dim] -> (quantized [B, T, vq_dim], prob_ppl scalar);
    prob_ppl = (G*V - sum_g exp(H(avg_probs_g))) / (G*V), wav2vec 2.0's
    diversity regulariser."""

    def __init__(self, cfg: GumbelVQConfig):
        super().__init__()
        if cfg.vq_dim % cfg.groups:
            raise ValueError("vq_dim must be a multiple of groups")
        self.cfg = cfg
        num_groups = 1 if cfg.combine_groups else cfg.groups
        self.vars = nn.Parameter(torch.zeros(num_groups * cfg.num_vars, cfg.vq_dim // cfg.groups))
        self.weight_proj = nn.Linear(cfg.dim, cfg.groups * cfg.num_vars)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers: the codebook uniform in [0, 1), the
        projection's kernel normal with stddev 1, its bias zero."""
        with torch.no_grad():
            self.vars.copy_(torch.rand(self.vars.shape, generator=generator))
            self.weight_proj.weight.copy_(torch.randn(self.weight_proj.weight.shape,
                                                      generator=generator))
            self.weight_proj.bias.zero_()

    def forward(self, x: torch.Tensor, temp: float, *, train: bool,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> tuple:
        """noise: the Gumbel draws [B, T, G, V] for training; without it
        they come from `generator`."""
        cfg = self.cfg
        b, t, _ = x.shape
        logits = F.linear(x.to(torch.float32), self.weight_proj.weight, self.weight_proj.bias)
        logits = logits.view(b, t, cfg.groups, cfg.num_vars)
        probs = torch.softmax(logits, dim=-1)
        avg_probs = probs.reshape(b * t, cfg.groups, cfg.num_vars).mean(dim=0)
        ppl = torch.exp(-(avg_probs * torch.log(avg_probs + 1e-7)).sum(dim=-1))
        total = cfg.num_vars * cfg.groups
        prob_ppl = (total - ppl.sum()) / total
        if train:
            if noise is None:
                if generator is None:
                    raise ValueError("train=True needs the Gumbel noise or a generator")
                noise = gumbel_noise(logits.shape, generator, logits.device)
            y_soft = torch.softmax((logits + noise.to(logits)) / temp, dim=-1)
            idx = y_soft.argmax(dim=-1)
            y_hard = F.one_hot(idx, cfg.num_vars).to(torch.float32)
            sel = y_hard + y_soft - y_soft.detach()
        else:
            sel = F.one_hot(logits.argmax(dim=-1), cfg.num_vars).to(torch.float32)
        cb = self.vars.view(-1, cfg.num_vars, cfg.vq_dim // cfg.groups)
        if cfg.combine_groups:
            cb = cb.expand(cfg.groups, -1, -1)
        quant = torch.einsum("btgv,gvd->btgd", sel, cb)
        return quant.reshape(b, t, cfg.vq_dim), prob_ppl
