"""Jasper / QuartzNet / MatchboxNet / CarneliNet convolutional encoder (port
of conformer_nemo_tpu/models/conv_asr.py).

A sequence of blocks, each `repeat` x [masked Conv1d (depthwise-separable
or grouped, strided, dilated) -> BatchNorm (eps 1e-3) -> ReLU -> dropout]
with residual projections (add | stride_add | max; every earlier pane with
`residual_dense`) and an optional squeeze-excite; a ParallelBlock runs one
tower per kernel size and sums them (tower dropout in training). Inputs are
zeroed past each row's length before every convolution; lengths follow
`conv_out_length`. A kernel of 1 takes neither the stride nor the dilation
(the JAX module's rule), while its length arithmetic still counts them.

Layout [B, C, T]. Submodules carry the JAX package's flax names (`block3`,
`conv0.depthwise`, `bn0`, `res_conv1`, `se.fc1`, `tower0`, ...), so
convert/jax_params.py maps the trees leaf for leaf.

Random draws come from the `generator` passed to `forward` in training:
the SE pool's context start (`_se_start`) and the ParallelBlock's tower
weights (`_tower_weights`), both module-level functions so that a test can
put the JAX package's draws in their place; and the dropout masks.
Convolutions run in `dtype` (fp32 in the label models); `fp32_convolutions`
keeps cuDNN from computing them in TF32.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from conformer_nemo_tpu_torch.models.conformer import BatchNorm, _linear
from conformer_nemo_tpu_torch.models.ssl import batch_norm


@contextlib.contextmanager
def fp32_convolutions():
    """cuDNN convolutions in true fp32 for the block (PyTorch lets cuDNN use
    TF32 for fp32 convolutions by default). Wrap the backward too."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


def compute_new_kernel_size(kernel: int, factor: float) -> int:
    """Scale a kernel size and round up to odd."""
    new = max(int(kernel * factor), 1)
    return new + 1 if new % 2 == 0 else new


@dataclasses.dataclass(frozen=True)
class JasperBlockConfig:
    """One entry of the encoder's block list; a tuple `kernel` makes a
    ParallelBlock (one tower per kernel size)."""

    filters: int = 256
    repeat: int = 1
    kernel: Any = 11
    stride: int = 1
    dilation: int = 1
    dropout: float = 0.0
    residual: bool = True
    separable: bool = False
    groups: int = 1
    se: bool = False
    se_reduction_ratio: int = 8
    se_context_window: int = -1  # < 1: global context
    residual_mode: str = "add"  # add | stride_add | max
    kernel_size_factor: float = 1.0
    stride_last: bool = False  # stride only on the last repeat
    residual_dense: bool = False  # Jasper-DR panes
    aggregation_mode: str = "sum"  # sum | dropout (tower dropout)
    block_dropout: float = 0.0
    parallel_residual_mode: str = "sum"  # sum | conv


@dataclasses.dataclass(frozen=True)
class ConvASREncoderConfig:
    feat_in: int = 80
    blocks: Sequence[JasperBlockConfig] = ()
    dtype: Any = torch.bfloat16


def _same_pad(kernel: int, dilation: int) -> int:
    return (dilation * (kernel - 1)) // 2


def conv_out_length(lengths: torch.Tensor, kernel: int, stride: int,
                    dilation: int) -> torch.Tensor:
    pad = _same_pad(kernel, dilation)
    return torch.floor((lengths.to(torch.float32) + 2 * pad - dilation * (kernel - 1) - 1)
                       / stride + 1).to(torch.int32)


def _se_start(generator: torch.Generator, high: int, device) -> int:
    """The SE pool's random context start in [0, high) (training)."""
    return int(torch.randint(0, high, (), generator=generator, device=device))


def _tower_weights(generator: torch.Generator, n: int, p: float, device) -> torch.Tensor:
    """Inverted-dropout keep weights of n towers, redrawn until one survives."""
    while True:
        keep = torch.rand(n, generator=generator, device=device) < 1.0 - p
        if bool(keep.any()):
            return keep.to(torch.float32) / (1.0 - p)


def _dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    if p <= 0.0:
        return x
    if generator is None:
        raise ValueError("training with dropout needs a generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def _length_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


class MaskedConv(nn.Module):
    """Conv1d (no bias) of an input zeroed past each row's length."""

    def __init__(self, c_in: int, features: int, kernel: int, stride: int, dilation: int,
                 separable: bool, groups: int, dtype):
        super().__init__()
        self.kernel, self.stride, self.dilation, self.dtype = kernel, stride, dilation, dtype
        pad = _same_pad(kernel, dilation)

        def conv(ci, co, k, g):
            return nn.Conv1d(ci, co, k, stride=stride if k > 1 else 1,
                             padding=pad if k > 1 else 0, dilation=dilation if k > 1 else 1,
                             groups=g, bias=False)

        self.separable = separable
        if separable:
            self.depthwise = conv(c_in, c_in, kernel, c_in)
            self.pointwise = conv(c_in, features, 1, 1)
        else:
            self.conv = conv(c_in, features, kernel, groups)

    @staticmethod
    def _run(mod: nn.Conv1d, x: torch.Tensor, dtype) -> torch.Tensor:
        return F.conv1d(x, mod.weight.to(dtype), None, mod.stride, mod.padding, mod.dilation,
                        mod.groups)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> tuple:
        """x [B, C, T] -> ([B, F, T'] in dtype, lengths')."""
        x = torch.where(_length_mask(lengths, x.shape[-1])[:, None, :], x, 0.0).to(self.dtype)
        if self.separable:
            x = self._run(self.pointwise, self._run(self.depthwise, x, self.dtype), self.dtype)
        else:
            x = self._run(self.conv, x, self.dtype)
        return x, conv_out_length(lengths, self.kernel, self.stride, self.dilation)


class SqueezeExcite(nn.Module):
    """Masked-mean squeeze-excite. A context window < 1 pools globally;
    otherwise the pool covers `context_window` frames from a random start in
    training and from frame 0 at inference."""

    def __init__(self, channels: int, reduction_ratio: int, dtype, context_window: int = -1):
        super().__init__()
        h = max(1, channels // reduction_ratio)
        self.fc1 = nn.Linear(channels, h)
        self.fc2 = nn.Linear(h, channels)
        self.dtype = dtype
        self.context_window = context_window

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        t = x.shape[-1]
        mask = _length_mask(lengths, t).to(x.dtype)
        xm = x * mask[:, None, :]
        cw = self.context_window
        if 0 < cw <= t:
            start = _se_start(generator, max(t - cw, 1), x.device) if self.training else 0
            m_sl = mask[:, start:start + cw]
            pooled = xm[:, :, start:start + cw].sum(-1) / (m_sl.sum(-1)[:, None] + 1e-8)
        else:
            pooled = xm.sum(-1) / torch.clamp(lengths.to(x.dtype), min=1.0)[:, None]
        y = _linear(self.fc2, F.relu(_linear(self.fc1, pooled, self.dtype)), self.dtype)
        return x * torch.sigmoid(y.to(torch.float32))[:, :, None].to(x.dtype)


class JasperBlock(nn.Module):
    """Takes and returns a list of panes [B, C, T] (Jasper-DR): the tower
    runs on the last; with `residual_dense` every pane gets a residual
    projection and the output is appended. `channels`: each pane's C."""

    def __init__(self, cfg: JasperBlockConfig, channels: Sequence[int], dtype):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        kernel = compute_new_kernel_size(int(cfg.kernel), cfg.kernel_size_factor)
        dense = cfg.residual and cfg.residual_dense and len(channels) > 1
        self.n_res = len(channels) if dense else 1
        c = channels[-1]
        for r in range(cfg.repeat):
            last = r == cfg.repeat - 1
            stride = 1 if (cfg.stride_last and not last) else cfg.stride
            self.add_module(f"conv{r}", MaskedConv(c, cfg.filters, kernel, stride, cfg.dilation,
                                                   cfg.separable, cfg.groups, dtype))
            self.add_module(f"bn{r}", BatchNorm(cfg.filters, eps=1e-3))
            c = cfg.filters
        if cfg.residual:
            res_channels = channels if dense else channels[-1:]
            for i, rc in enumerate(res_channels):
                suffix = "" if i == 0 else str(i)
                stride = cfg.stride if cfg.residual_mode == "stride_add" else 1
                self.add_module(f"res_conv{suffix}",
                                MaskedConv(rc, cfg.filters, 1, stride, 1, False, 1, dtype))
                self.add_module(f"res_bn{suffix}", BatchNorm(cfg.filters, eps=1e-3))
        if cfg.se:
            self.se = SqueezeExcite(cfg.filters, cfg.se_reduction_ratio, dtype,
                                    cfg.se_context_window)

    def out_channels(self, channels: Sequence[int]) -> list:
        cfg = self.cfg
        return (list(channels) + [cfg.filters] if cfg.residual and cfg.residual_dense
                else [cfg.filters])

    def forward(self, xs: List[torch.Tensor], lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> tuple:
        cfg = self.cfg
        res_inputs = list(xs[-self.n_res:]) if self.n_res > 1 else [xs[-1]]
        x, res_lengths = xs[-1], lengths
        for r in range(cfg.repeat):
            x, lengths = getattr(self, f"conv{r}")(x, lengths)
            x = batch_norm(getattr(self, f"bn{r}"), x.to(torch.float32))
            if r == cfg.repeat - 1 and cfg.residual:
                for i, res_in in enumerate(res_inputs):
                    suffix = "" if i == 0 else str(i)
                    res, _ = getattr(self, f"res_conv{suffix}")(res_in, res_lengths)
                    res = batch_norm(getattr(self, f"res_bn{suffix}"), res.to(torch.float32))
                    res = res[..., : x.shape[-1]]
                    x = torch.maximum(x, res) if cfg.residual_mode == "max" else x + res
            x = F.relu(x)
            if self.training:
                x = _dropout(x.to(self.dtype), cfg.dropout, generator)
            x = x.to(self.dtype).to(torch.float32)
        if cfg.se:
            x = self.se(x, lengths, generator)
        out = list(xs) + [x] if cfg.residual and cfg.residual_dense else [x]
        return out, lengths


class ParallelBlock(nn.Module):
    """One JasperBlock per kernel size on the same input, summed (with
    tower-dropout weights in training when aggregation_mode is 'dropout'),
    plus the block input directly ('sum') or through a 1x1 conv ('conv')."""

    def __init__(self, cfg: JasperBlockConfig, channels: Sequence[int], dtype):
        super().__init__()
        self.cfg = cfg
        self.kernels = tuple(int(k) for k in cfg.kernel)
        for j, k in enumerate(self.kernels):
            self.add_module(f"tower{j}", JasperBlock(dataclasses.replace(cfg, kernel=k),
                                                     channels, dtype))
        if cfg.parallel_residual_mode == "conv":
            self.res_conv = MaskedConv(channels[-1], cfg.filters, 1, 1, 1, False, 1, dtype)

    def out_channels(self, channels: Sequence[int]) -> list:
        return [self.cfg.filters]

    def forward(self, xs: List[torch.Tensor], lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> tuple:
        cfg = self.cfg
        outs, out_lengths = [], None
        for j in range(len(self.kernels)):
            sub_out, sub_len = getattr(self, f"tower{j}")(xs, lengths, generator)
            outs.append(sub_out[-1])
            out_lengths = sub_len if out_lengths is None else torch.maximum(out_lengths, sub_len)
        if cfg.aggregation_mode == "dropout" and self.training and cfg.block_dropout > 0.0:
            weights = _tower_weights(generator, len(outs), cfg.block_dropout, xs[-1].device)
            result = sum(w * o for w, o in zip(weights, outs))
        else:
            result = sum(outs)
        if cfg.parallel_residual_mode == "conv":
            res, _ = self.res_conv(xs[-1], lengths)
            result = result + res
        else:  # 'sum': needs matching channels
            result = result + xs[-1]
        return [result], out_lengths


class ConvASREncoder(nn.Module):
    """[B, D_feat, T] + lengths -> [B, C_last, T'] (fp32) + lengths'."""

    def __init__(self, cfg: ConvASREncoderConfig):
        super().__init__()
        self.cfg = cfg
        channels = [cfg.feat_in]
        for i, bcfg in enumerate(cfg.blocks):
            cls = ParallelBlock if isinstance(bcfg.kernel, (tuple, list)) else JasperBlock
            block = cls(bcfg, channels, cfg.dtype)
            self.add_module(f"block{i}", block)
            channels = block.out_channels(channels)

    def forward(self, features: torch.Tensor, lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> tuple:
        xs = [features.to(torch.float32)]
        for i in range(len(self.cfg.blocks)):
            xs, lengths = getattr(self, f"block{i}")(xs, lengths, generator)
        return xs[-1], lengths


def quartznet_15x5_blocks(feat_out: int = 1024) -> List[JasperBlockConfig]:
    """The QuartzNet 15x5 topology."""
    blocks = [JasperBlockConfig(filters=256, repeat=1, kernel=33, stride=2, residual=False,
                                separable=True, dropout=0.0)]
    for k, f in [(33, 256), (39, 256), (51, 512), (63, 512), (75, 512)]:
        for _ in range(3):
            blocks.append(JasperBlockConfig(filters=f, repeat=5, kernel=k, residual=True,
                                            separable=True))
    blocks.append(JasperBlockConfig(filters=512, repeat=1, kernel=87, dilation=2,
                                    residual=False, separable=True))
    blocks.append(JasperBlockConfig(filters=feat_out, repeat=1, kernel=1, residual=False,
                                    separable=False))
    return blocks


def change_se_context_window(blocks: Sequence[JasperBlockConfig],
                             context_window: int) -> List[JasperBlockConfig]:
    """The blocks with every SE's context window swapped (streaming
    inference); the parameters are unchanged."""
    return [dataclasses.replace(b, se_context_window=context_window) if b.se else b
            for b in blocks]
