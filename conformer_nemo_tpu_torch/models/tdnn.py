"""TDNN / ECAPA speaker-embedding stack (port of
conformer_nemo_tpu/models/tdnn.py): the ECAPA encoder (a TDNN stem, SE-TDNN
residual blocks, the concatenation of their outputs, a TDNN aggregation),
statistics and attentive pooling, and the speaker decoder (pooling ->
embedding layers -> class logits).

Layout [B, C, T]; BatchNorm is flax's with eps 1e-5 (the port's training
BatchNorm). `MaskedSEModule` normalises its pooled [B, C] vector, so its
statistics are over the batch alone. The angular head normalises both the
class rows and the embedding, so its logits are exact cosines: the JAX
package's documented deviation from the reference, whose normalisation is a
no-op. Submodules carry the flax names (`stem`, `block0.tdnn_in.conv`,
`block0.group_conv`, `block0.se.fc1`, `agg`, `pool.attn_tdnn`,
`emb0_bn`, `emb0_fc`, `final_kernel` [in, classes] as flax stores it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from conformer_nemo_tpu_torch.models.conformer import BatchNorm, _linear
from conformer_nemo_tpu_torch.models.ssl import batch_norm


def _time_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


def masked_stats(x: torch.Tensor, weights: torch.Tensor, eps: float = 1e-10) -> tuple:
    """Weighted mean and std over time of x [B, C, T]; weights [B, C|1, T]
    sum to 1 over T."""
    mean = (weights * x).sum(-1)
    var = (weights * (x - mean[:, :, None]).square()).sum(-1)
    return mean, torch.sqrt(torch.clamp(var, min=eps))


def _conv(mod: nn.Conv1d, x: torch.Tensor, dtype) -> torch.Tensor:
    return F.conv1d(x.to(dtype), mod.weight.to(dtype), mod.bias.to(dtype), 1, mod.padding,
                    mod.dilation, mod.groups)


class TDNNModule(nn.Module):
    """Conv1d (same padding, with bias) -> ReLU -> BatchNorm."""

    def __init__(self, c_in: int, features: int, kernel: int = 1, dilation: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        self.conv = nn.Conv1d(c_in, features, kernel, padding=(dilation * (kernel - 1)) // 2,
                              dilation=dilation)
        self.bn = BatchNorm(features, eps=1e-5)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(self.bn, F.relu(_conv(self.conv, x, self.dtype)).to(torch.float32))


class MaskedSEModule(nn.Module):
    """Squeeze-excite over the length-masked mean."""

    def __init__(self, channels: int, se_channels: int, out_channels: int, dtype=torch.bfloat16):
        super().__init__()
        self.fc1 = nn.Linear(channels, se_channels)
        self.bn = BatchNorm(se_channels, eps=1e-5)
        self.fc2 = nn.Linear(se_channels, out_channels)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        mask = _time_mask(lengths, x.shape[-1]).to(torch.float32)[:, None, :]
        pooled = (x.to(torch.float32) * mask).sum(-1) / torch.clamp(mask.sum(-1), min=1.0)
        y = F.relu(_linear(self.fc1, pooled, self.dtype))
        y = batch_norm(self.bn, y.to(torch.float32))
        gate = torch.sigmoid(_linear(self.fc2, y, self.dtype).to(torch.float32))
        return x * gate[:, :, None].to(x.dtype)


class TDNNSEModule(nn.Module):
    """SE-TDNN residual block: 1x1 TDNN -> grouped dilated conv -> ReLU ->
    BatchNorm -> 1x1 TDNN -> masked SE -> + input."""

    def __init__(self, c_in: int, filters: int, group_scale: int = 8, se_channels: int = 128,
                 kernel: int = 1, dilation: int = 1, dtype=torch.bfloat16):
        super().__init__()
        self.tdnn_in = TDNNModule(c_in, filters, 1, 1, dtype)
        self.group_conv = nn.Conv1d(filters, filters, kernel,
                                    padding=(dilation * (kernel - 1)) // 2, dilation=dilation,
                                    groups=group_scale)
        self.bn = BatchNorm(filters, eps=1e-5)
        self.tdnn_out = TDNNModule(filters, filters, 1, 1, dtype)
        self.se = MaskedSEModule(filters, se_channels, filters, dtype)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        y = self.tdnn_in(x)
        y = batch_norm(self.bn, F.relu(_conv(self.group_conv, y, self.dtype)).to(torch.float32))
        return self.se(self.tdnn_out(y), lengths) + x


@dataclasses.dataclass(frozen=True)
class ECAPAEncoderConfig:
    feat_in: int = 80
    filters: Sequence[int] = (512, 512, 512, 512, 1536)
    kernel_sizes: Sequence[int] = (5, 3, 3, 3, 1)
    dilations: Sequence[int] = (1, 2, 3, 4, 1)
    scale: int = 8
    dtype: Any = torch.bfloat16


class ECAPAEncoder(nn.Module):
    """[B, feat_in, T] -> [B, filters[-1], T]; lengths pass through."""

    def __init__(self, cfg: ECAPAEncoderConfig):
        super().__init__()
        self.cfg = cfg
        f, k, d = cfg.filters, cfg.kernel_sizes, cfg.dilations
        self.stem = TDNNModule(cfg.feat_in, f[0], k[0], d[0], cfg.dtype)
        for i in range(len(f) - 2):
            self.add_module(f"block{i}", TDNNSEModule(f[i], f[i + 1], cfg.scale, 128, k[i + 1],
                                                      d[i + 1], cfg.dtype))
        self.agg = TDNNModule(sum(f[1:-1]), f[-1], k[-1], d[-1], cfg.dtype)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> tuple:
        x = self.stem(x)
        outs = []
        for i in range(len(self.cfg.filters) - 2):
            x = getattr(self, f"block{i}")(x, lengths)
            outs.append(x)
        return self.agg(torch.cat(outs, dim=1)), lengths


class StatsPool(nn.Module):
    """Unmasked mean (tap) or mean and std (xvector, ddof 1) over time: the
    speaker loaders repeat short signals to a fixed length."""

    def __init__(self, pool_mode: str = "xvector"):
        super().__init__()
        self.pool_mode = pool_mode

    def forward(self, x: torch.Tensor, lengths=None) -> torch.Tensor:
        xf = x.to(torch.float32)
        mean = xf.mean(-1)
        if self.pool_mode == "tap":
            return mean
        return torch.cat([mean, xf.std(-1, correction=1)], dim=-1)


class AttentivePool(nn.Module):
    """Attentive statistics pooling: attention over [x, masked mean, masked
    std] -> softmax over the valid frames -> weighted mean and std [B, 2C]."""

    def __init__(self, channels: int, attention_channels: int = 128, dtype=torch.bfloat16):
        super().__init__()
        self.attn_tdnn = TDNNModule(3 * channels, attention_channels, 1, 1, dtype)
        self.attn_proj = nn.Linear(attention_channels, channels)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mask = _time_mask(lengths, x.shape[-1]).to(torch.float32)[:, None, :]  # [B, 1, T]
        w = mask / torch.clamp(mask.sum(-1, keepdim=True), min=1.0)
        mean, std = masked_stats(xf, w)
        attn_in = torch.cat([xf, mean[:, :, None].expand_as(xf), std[:, :, None].expand_as(xf)],
                            dim=1)
        a = torch.tanh(self.attn_tdnn(attn_in))
        a = _linear(self.attn_proj, a.transpose(1, 2), self.dtype).to(torch.float32)
        a = torch.where(mask > 0, a.transpose(1, 2), float("-inf"))
        mu, sg = masked_stats(xf, torch.softmax(a, dim=-1))
        return torch.cat([mu, sg], dim=-1)


@dataclasses.dataclass(frozen=True)
class SpeakerDecoderConfig:
    feat_in: int = 1536
    num_classes: int = 2
    emb_sizes: Sequence[int] = (192,)
    pool_mode: str = "attention"  # xvector | tap | attention
    angular: bool = False
    attention_channels: int = 128
    dtype: Any = torch.bfloat16


class SpeakerDecoder(nn.Module):
    """Pooling -> embedding layers -> class logits. -> (logits [B, V],
    embedding [B, emb_sizes[-1]]): the last embedding layer's output before
    its activation."""

    def __init__(self, cfg: SpeakerDecoderConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.pool_mode in ("xvector", "tap"):
            self.pool = StatsPool(cfg.pool_mode)
            width = cfg.feat_in * (2 if cfg.pool_mode == "xvector" else 1)
        elif cfg.pool_mode == "attention":
            self.pool = AttentivePool(cfg.feat_in, cfg.attention_channels, cfg.dtype)
            width = 2 * cfg.feat_in
        else:
            raise ValueError(f"unknown pool_mode {cfg.pool_mode!r}")
        attention = cfg.pool_mode == "attention"
        for i, size in enumerate(cfg.emb_sizes):
            if attention:  # BatchNorm -> 1x1 conv (a dense layer on the pooled vector)
                self.add_module(f"emb{i}_bn", BatchNorm(width, eps=1e-5))
                self.add_module(f"emb{i}_fc", nn.Linear(width, int(size)))
            else:  # dense -> BatchNorm without scale and shift -> ReLU
                self.add_module(f"emb{i}_fc", nn.Linear(width, int(size)))
                self.add_module(f"emb{i}_bn", BatchNorm(int(size), eps=1e-5, affine=False))
            width = int(size)
        self.final_kernel = nn.Parameter(torch.zeros(width, cfg.num_classes))
        if not cfg.angular:
            self.final_bias = nn.Parameter(torch.zeros(cfg.num_classes))

    def reset_final(self, generator: torch.Generator) -> None:
        """flax's xavier-uniform final kernel."""
        fan_in, fan_out = self.final_kernel.shape
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        with torch.no_grad():
            self.final_kernel.copy_((torch.rand(self.final_kernel.shape, generator=generator)
                                     * 2 - 1) * bound)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> tuple:
        cfg = self.cfg
        h = self.pool(x, lengths)
        emb = h
        for i in range(len(cfg.emb_sizes)):
            bn, fc = getattr(self, f"emb{i}_bn"), getattr(self, f"emb{i}_fc")
            if cfg.pool_mode == "attention":
                h = _linear(fc, batch_norm(bn, h.to(torch.float32)), cfg.dtype).to(torch.float32)
                emb = h
            else:
                h = batch_norm(bn, _linear(fc, h, cfg.dtype).to(torch.float32))
                emb = h
                h = F.relu(h)
        w = self.final_kernel
        if cfg.angular:
            hn = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True), min=1e-12)
            wn = w / torch.clamp(torch.linalg.vector_norm(w, dim=0, keepdim=True), min=1e-12)
            return hn @ wn, emb
        return h @ w + self.final_bias, emb
