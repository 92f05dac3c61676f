"""Conformer encoder (port of conformer_nemo_tpu/models/conformer.py).

    subsampling (the conv modes striding, vggnet, resnet and subencoder,
    Linear over C*F'; stacking; or a Linear at factor 1 / `none`) ->
    xscale * x + positional encoding -> N x [half-FF -> MHSA -> conv module
    (pointwise -> GLU -> depthwise k -> norm -> swish -> pointwise) ->
    half-FF -> LayerNorm].

Parameter names are NeMo's (`pre_encode.conv.0`, `layers.N.self_attn.linear_q`,
`conv.depthwise_conv`, `conv.batch_norm`, ...), with NeMo's layouts, so a
NeMo state_dict loads as it is and convert/jax_params.py bridges the JAX
package's variables.

Precision follows the JAX package: parameters fp32; linears, convolutions
and attention matmuls in the compute dtype (`cfg.dtype`, bf16 by default);
LayerNorm, BatchNorm, softmax and residual adds in fp32.

Training follows the JAX package too: `FastDropout` at every site it has
(encoder input, rel-pos embedding, FF hidden, branch outputs, dense-path
attention probabilities), with masks that are a pure function of a
per-step seed and the site, so a layer recomputed under `remat`
(`torch.utils.checkpoint`) draws the same masks; training BatchNorm with
flax's statistics, whose running update the encoder applies once per
forward, outside the checkpoint. `self.training` selects training mode;
the encoder's `dropout_seed` seeds the masks. The resnet and subencoder
front ends' 2-D BatchNorms train the same way; their statistics, like the
layers', reach the running buffers once per forward.

Across GPUs (parallel/): the training BatchNorm sums its statistics over
the mesh's data group (`BatchNorm.sync_group`), and the feed-forward,
attention and convolution modules run tensor-parallel over its model
group when `tp` is set (parallel/sharding.py holds the sharding rules).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from conformer_nemo_tpu_torch.ops.flash_attention import (
    check_bwd_depth,
    check_depth,
    flash_attention,
)
from conformer_nemo_tpu_torch.parallel.distributed import all_reduce_sum
from conformer_nemo_tpu_torch.parallel.sharding import (
    TensorParallel,
    copy_to_tp,
    reduce_from_tp,
)


logger = logging.getLogger(__name__)
# (d1, dv, dtype) for which "auto" took the dense attention because no flash
# kernel takes the depth, said once each
_DENSE_FOR_DEPTH: set = set()


@dataclasses.dataclass(frozen=True)
class ConformerEncoderConfig:
    """Schema mirror of the reference encoder config."""

    feat_in: int = 80
    n_layers: int = 18
    d_model: int = 512
    feat_out: int = -1
    subsampling: str = "striding"  # striding | vggnet | resnet | subencoder | stacking | none
    subsampling_factor: int = 4
    subsampling_conv_channels: int = -1
    ff_expansion_factor: int = 4
    self_attention_model: str = "rel_pos"  # rel_pos | abs_pos
    n_heads: int = 8
    att_context_size: tuple[int, int] = (-1, -1)
    xscaling: bool = True
    untie_biases: bool = True
    pos_emb_max_len: int = 5000
    conv_kernel_size: int = 31
    conv_norm_type: str = "batch_norm"  # batch_norm | layer_norm
    dropout: float = 0.1
    dropout_emb: float = 0.0
    dropout_att: float = 0.1
    dtype: Any = torch.bfloat16  # compute dtype; params always fp32
    # flash attention (hand-written CUDA kernel, ops/flash_attention.py):
    # True | False | "auto"; "auto" takes it once T >= flash_attention_min_t
    use_flash_attention: Any = "auto"
    flash_attention_min_t: int = 1024
    # recompute each layer in the backward (torch.utils.checkpoint)
    remat: bool = False

    @property
    def d_ff(self) -> int:
        return self.d_model * self.ff_expansion_factor

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads


# mode -> (padding, kernel, stride, ceil_mode) of the length-determining op
_SUBSAMPLING_GEOM = {
    "striding": (1, 3, 2, False),
    "vggnet": (0, 2, 2, True),
    "resnet": (0, 2, 2, True),
    "subencoder": (1, 4, 2, False),
}


def calc_sub_length(lengths: torch.Tensor, mode: str, reps: int) -> torch.Tensor:
    """Output length after `reps` applications of the mode's length op
    (float32 arithmetic, as the reference calc_length)."""
    pad, k, s, ceil = _SUBSAMPLING_GEOM[mode]
    out = lengths.to(torch.float32)
    for _ in range(reps):
        out = (out + 2 * pad - k) / s + 1.0
        out = torch.ceil(out) if ceil else torch.floor(out)
    return out.to(torch.int32)


def uses_conv_subsampling(cfg) -> bool:
    return cfg.subsampling in _SUBSAMPLING_GEOM and cfg.subsampling_factor > 1


def _stacking_pad(factor: int, t_in: int) -> int:
    """Stacking pads the padded batch's T to a multiple of the factor, and
    by a whole factor when it already is one (the reference always pads)."""
    return factor - (t_in % factor) if t_in % factor else factor


def _check_mode(cfg) -> None:
    if cfg.subsampling_factor > 1 and cfg.subsampling not in (
            *_SUBSAMPLING_GEOM, "stacking", "none", "", None):
        raise ValueError(f"unknown subsampling mode: {cfg.subsampling!r} (striding | vggnet | "
                         "resnet | subencoder | stacking | none)")


def encoder_lengths(cfg, lengths: torch.Tensor, t_in: int) -> torch.Tensor:
    """The encoder's output lengths for input lengths of a batch padded to
    `t_in` frames, in every mode, as the JAX encoder computes them: the
    conv modes' length rule, stacking's (lengths + pad) // f with the pad
    taken from `t_in`, and the lengths themselves at factor 1 / `none`."""
    lengths = torch.as_tensor(lengths)
    if uses_conv_subsampling(cfg):
        return calc_sub_length(lengths, cfg.subsampling, int(math.log2(cfg.subsampling_factor)))
    if cfg.subsampling == "stacking" and cfg.subsampling_factor > 1:
        f = cfg.subsampling_factor
        return ((lengths + _stacking_pad(f, t_in)) // f).to(torch.int32)
    return lengths.to(torch.int32)


def frame_factor(cfg) -> int:
    """Input frames per encoder frame: the subsampling factor, or 1 where
    the encoder does not subsample (factor 1 / `none`)."""
    subsampled = uses_conv_subsampling(cfg) or cfg.subsampling == "stacking"
    return cfg.subsampling_factor if subsampled else 1


def freq_out(cfg) -> int:
    """The frequency size after a conv mode's subsampling (the time rule
    applied to feat_in)."""
    return int(calc_sub_length(torch.tensor(cfg.feat_in), cfg.subsampling,
                               int(math.log2(cfg.subsampling_factor))))


def _inv_freq(d_model: int) -> np.ndarray:
    return np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model))


def _sinusoidal_pe(positions: np.ndarray, d_model: int) -> np.ndarray:
    """[len(positions), D]: even dims sin(pos*w), odd dims cos(pos*w)."""
    angle = positions.astype(np.float64)[:, None] * _inv_freq(d_model)
    pe = np.zeros((len(positions), d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(angle)
    pe[:, 1::2] = np.cos(angle)
    return pe.astype(np.float32)


def sinusoidal_rel_pos_emb(length: int, d_model: int) -> np.ndarray:
    """Relative PE for positions (length-1) .. -(length-1), [2L-1, D]."""
    return _sinusoidal_pe(np.arange(length - 1, -length, -1), d_model)


def sinusoidal_abs_pos_emb(length: int, d_model: int) -> np.ndarray:
    return _sinusoidal_pe(np.arange(length), d_model)


def sin_cos_tables(t: int, d_model: int, dtype: torch.dtype, device) -> tuple:
    """sin/cos(i * w) for i < t, [T, D/2] each (the bd decomposition), from
    float64 numpy values cast to the compute dtype, on the device."""
    pos = np.arange(t, dtype=np.float64)[:, None] * _inv_freq(d_model)[None, :]
    return (torch.from_numpy(np.sin(pos)).to(device, dtype),
            torch.from_numpy(np.cos(pos)).to(device, dtype))


def sub_seed(seed: Optional[int], index: int) -> Optional[int]:
    """The dropout seed of sub-site `index` of `seed` (None stays None)."""
    return None if seed is None else (seed * 1_000_003 + index + 1) % (1 << 62)


# the sub-sites of a data-parallel rank's and a tensor-parallel shard's
# streams: past every layer's and every site's index
_RANK_SITE, _SHARD_SITE = 1 << 32, 2 << 32


def rank_seed(seed: int, data_index: int) -> int:
    """A step seed as data-parallel rank `data_index` draws it: each rank's
    rows get masks of their own, and index 0 keeps the step's seed, so a
    world of one draws as one process does."""
    return seed if data_index == 0 else sub_seed(seed, _RANK_SITE + data_index)


def shard_seed(seed: Optional[int], tp: Optional[TensorParallel]) -> Optional[int]:
    """The dropout seed of a sharded activation: the ranks of a model group
    share the step's seed, and each shard draws a mask of its own."""
    if seed is None or tp is None or tp.rank == 0:
        return seed
    return sub_seed(seed, _SHARD_SITE + tp.rank)


def fast_dropout(x: torch.Tensor, rate: float, seed: Optional[int]) -> torch.Tensor:
    """The JAX package's FastDropout: uint8 random bits, drop iff
    bits < t with t = round(rate * 256), rescale by the realised keep rate
    1 - t/256, so E[out] == x exactly. The bits come from a generator seeded
    with `seed` alone; seed None (deterministic mode) or t = 0 is identity."""
    t = int(round(rate * 256))
    if seed is None or t <= 0:
        return x
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    bits = torch.randint(0, 256, x.shape, generator=gen, dtype=torch.uint8, device=x.device)
    keep = 1.0 - t / 256.0
    return torch.where(bits >= t, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Transformer-XL relative shift of [B, H, T, 2T-1] scores: pad-left one
    column, fold, drop the first row."""
    b, h, qlen, pos_len = x.shape
    x = F.pad(x, (1, 0))
    x = x.reshape(b, h, pos_len + 1, qlen)
    return x[:, :, 1:, :].reshape(b, h, qlen, pos_len)


def make_masks(cfg: ConformerEncoderConfig, t: int, lengths: torch.Tensor):
    """(pad_mask [B,T] True=PAD, att_mask [B,T,T] True=MASKED) from lengths;
    att[i,j] allowed iff both valid and -left <= j - i <= right."""
    idx = torch.arange(t, device=lengths.device)
    valid = idx[None, :] < lengths[:, None]
    att_ok = valid[:, :, None] & valid[:, None, :]
    left, right = cfg.att_context_size
    rel = idx[:, None] - idx[None, :]  # i - j
    if left >= 0:
        att_ok = att_ok & (rel <= left)[None]
    if right >= 0:
        att_ok = att_ok & (-rel <= right)[None]
    return ~valid, ~att_ok


def _linear(mod: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """nn.Linear in the compute dtype (params stay fp32)."""
    bias = None if mod.bias is None else mod.bias.to(dtype)
    return F.linear(x.to(dtype), mod.weight.to(dtype), bias)


def _row_linear(weight: torch.Tensor, bias: torch.Tensor, x: torch.Tensor, dtype: torch.dtype,
                tp) -> torch.Tensor:
    """x @ weight^T + bias in the compute dtype; under tensor parallelism
    weight holds this rank's input columns: the ranks' partial products are
    summed in fp32 and the bias added after the sum."""
    if tp is None:
        return F.linear(x.to(dtype), weight.to(dtype), bias.to(dtype))
    y = reduce_from_tp(F.linear(x.to(dtype), weight.to(dtype)).to(torch.float32), tp)
    return (y + bias.to(torch.float32)).to(dtype)


def _layer_norm(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=1e-6)  # flax LayerNorm's epsilon


def _fp32_norm(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return mod(x.to(torch.float32))


class BatchNorm(nn.Module):
    """BatchNorm over channel dim 1 of [B, C, T] (the conv module's) or
    [B, C, T, F] (the resnet and subencoder front ends') with NeMo's
    parameter names (weight, bias, running_mean, running_var), in fp32 with
    eps 1e-5.

    Training mode has flax's semantics (the JAX package's nn.BatchNorm,
    momentum 0.9): statistics over every (B, T[, F]) position, padded frames
    included, with the biased variance E[x^2] - E[x]^2 (clipped at 0) in
    the normalisation and in the running update. `forward` returns the
    batch statistics beside the output instead of updating the buffers, so
    a recomputed forward (remat) cannot update them twice: the encoder calls
    `update_running_stats` once. (F.batch_norm's running variance is the
    unbiased estimate, which does not match; nor does nn.SyncBatchNorm's.)

    With `sync_group` set (the mesh's data group, parallel/sharding.py
    `set_sync_batchnorm`), the per-channel sums of x and x*x and the count
    of (B, T) positions are summed over the group by an all-reduce that
    carries the gradient, so every rank normalises with the global batch's
    statistics, as the JAX package's data-sharded BatchNorm does, and every
    rank's running statistics stay equal.

    `eps` is flax's epsilon (the label models' 1e-3 and 1e-5); `affine=False`
    is flax's BatchNorm without scale and bias."""

    momentum = 0.9
    sync_group = None

    def __init__(self, channels: int, eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        else:  # flax's use_scale=False, use_bias=False: unit scale, zero shift
            self.register_buffer("weight", torch.ones(channels), persistent=False)
            self.register_buffer("bias", torch.zeros(channels), persistent=False)
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor):
        """-> (y, (mean, var) detached in training mode, else None)."""
        x = x.to(torch.float32)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                training=False, eps=self.eps), None
        dims = (0, *range(2, x.dim()))
        sums = torch.cat([x.sum(dim=dims), (x * x).sum(dim=dims),
                          torch.full((1,), float(x.numel() // x.shape[1]), device=x.device)])
        if self.sync_group is not None:
            sums = all_reduce_sum(sums, self.sync_group)
        c = x.shape[1]
        mean = sums[:c] / sums[2 * c]
        var = torch.clamp(sums[c: 2 * c] / sums[2 * c] - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        per_channel = (c,) + (1,) * (x.dim() - 2)
        y = (x - mean.view(per_channel)) * mul.view(per_channel) + self.bias.view(per_channel)
        return y, (mean.detach(), var.detach())

    @torch.no_grad()
    def update_running_stats(self, stats) -> None:
        mean, var = stats
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)


def _can_flash(cfg: ConformerEncoderConfig) -> bool:
    """The attention can take the flash path at some length."""
    return (cfg.self_attention_model == "rel_pos" and cfg.dropout_emb == 0.0
            and cfg.use_flash_attention is not False)


def dense_for_depth(cfg: ConformerEncoderConfig, device) -> bool:
    """True where `use_flash_attention` is "auto" on CUDA and no flash
    kernel takes the encoder's depths d1 = d_head + d_model and dv = d_head
    in its dtype (`ops.flash_attention.check_depth` refuses dv > 128, and in
    the 16-bit types a d1 past the forward's shared memory): such an
    encoder takes the dense path, and a log line says so once per (d1, dv,
    dtype). An explicit True is refused at construction instead
    (`check_flash_dtype`), and a dtype no kernel takes is refused either
    way."""
    if cfg.use_flash_attention != "auto" or torch.device(device).type != "cuda":
        return False
    d1, dv = cfg.d_head + cfg.d_model, cfg.d_head
    try:
        check_depth(d1, dv, cfg.dtype)
    except TypeError:
        return False
    except ValueError as e:
        if (d1, dv, cfg.dtype) not in _DENSE_FOR_DEPTH:
            _DENSE_FOR_DEPTH.add((d1, dv, cfg.dtype))
            logger.warning("use_flash_attention auto: the dense attention, since the flash "
                           "kernels cannot take d1=%d, dv=%d in %s (%s)", d1, dv, cfg.dtype, e)
        return True
    return False


def check_flash_dtype(cfg: ConformerEncoderConfig, device) -> None:
    """The CUDA flash kernels take bf16, fp16 and fp32 at d1 = d_head +
    d_model, dv = d_head <= 128, and in the 16-bit types d1 up to the
    forward's shared memory (`ops.flash_attention.check_depth`). Refuse a
    CUDA encoder whose attention can take the flash path in a dtype or at a
    depth no kernel takes, before any work, rather than at its first batch
    with T >= flash_attention_min_t; under "auto" a depth no kernel takes
    sends the attention to the dense path (`dense_for_depth`)."""
    if torch.device(device).type != "cuda" or not _can_flash(cfg) or dense_for_depth(cfg, device):
        return
    try:
        check_depth(cfg.d_head + cfg.d_model, cfg.d_head, cfg.dtype)
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"this encoder's flash attention cannot run on CUDA in {cfg.dtype} at "
            f"d_model={cfg.d_model}, n_heads={cfg.n_heads}: {e}. Set "
            "model.encoder.use_flash_attention=False for the dense path") from None


def check_flash_training(cfg: ConformerEncoderConfig, device, longest_t: int) -> None:
    """The CUDA flash backward kernels take every depth the forward takes
    (their libraries report their limits). Refuse, before the first training
    step, a CUDA encoder whose attention can take the flash path in training
    (`RelPosMultiHeadAttention.use_flash` in training mode, at the longest
    batch of `longest_t` frames) in a dtype or at a depth the kernels cannot
    take; otherwise the forward would run and the first backward raise."""
    want = cfg.use_flash_attention is True or (
        cfg.use_flash_attention == "auto" and longest_t >= cfg.flash_attention_min_t)
    can_flash = (cfg.self_attention_model == "rel_pos" and cfg.dropout_emb == 0.0
                 and cfg.dropout_att == 0.0 and want)
    if torch.device(device).type != "cuda" or not can_flash or dense_for_depth(cfg, device):
        return
    d1, dv = cfg.d_head + cfg.d_model, cfg.d_head
    try:
        check_depth(d1, dv, cfg.dtype)
        check_bwd_depth(d1, dv, dtype=cfg.dtype)
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"this encoder's flash attention cannot train on CUDA in {cfg.dtype} at "
            f"d_model={cfg.d_model}, n_heads={cfg.n_heads}: {e}. Set "
            "model.encoder.use_flash_attention=False for the dense path") from None


class RelPosMultiHeadAttention(nn.Module):
    """Multi-head self-attention with Transformer-XL relative positional terms.

    As in the JAX package, bd[i,j] = qv[i] . pe(i-j) is computed through the
    angle-addition decomposition

        bd = [qs*sinI + qc*cosI | -qs*cosI + qc*sinI] @ [cosJ | sinJ]^T

    so no [B,H,T,2T-1] tensor and no shift is needed; the rel_shift form is
    kept for pos-emb dropout (dropout_emb > 0), which the decomposition cannot
    express. With the decomposition the whole score is one extended-depth
    product Qs Ks^T, which the flash kernel takes.

    Under tensor parallelism (`tp`, parallel/sharding.py) the module holds
    n_heads / tp.size heads: q, k, v, pos and the biases u, v are
    head-sharded, linear_out row-parallel."""

    TENSOR_PARALLEL = True
    tp = None

    def __init__(self, cfg: ConformerEncoderConfig, shared_biases=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.linear_q = nn.Linear(d, d)
        self.linear_k = nn.Linear(d, d)
        self.linear_v = nn.Linear(d, d)
        self.linear_out = nn.Linear(d, d)
        self.linear_pos = nn.Linear(d, d, bias=False)
        if shared_biases is None:
            self.pos_bias_u = nn.Parameter(torch.zeros(cfg.n_heads, cfg.d_head))
            self.pos_bias_v = nn.Parameter(torch.zeros(cfg.n_heads, cfg.d_head))
        else:  # untie_biases=False: the encoder's pair, registered here too (NeMo)
            self.pos_bias_u, self.pos_bias_v = shared_biases

    def use_flash(self, t: int, lengths) -> bool:
        """The JAX dispatch: flash when wanted (True, or "auto" at T >=
        flash_attention_min_t), with the decomposition (dropout_emb == 0),
        lengths, and no attention dropout to apply (eval mode, or
        dropout_att == 0): the kernel has no dropout epilogue. Under "auto"
        on CUDA, not at depths no kernel takes (`dense_for_depth`)."""
        cfg = self.cfg
        want = cfg.use_flash_attention is True or (
            cfg.use_flash_attention == "auto" and t >= cfg.flash_attention_min_t)
        deterministic = not self.training
        return (want and cfg.dropout_emb == 0.0 and lengths is not None
                and (deterministic or cfg.dropout_att == 0.0)
                and not dense_for_depth(cfg, lengths.device))

    def forward(self, x, pos_emb, sin_cos, att_mask, lengths=None, seed=None):
        """sin_cos: the encoder's (sin, cos) tables [T, D/2] in the compute
        dtype (decomposition); pos_emb: [2T-1, D] (rel_shift path only);
        seed: this site's dropout seed (None = no attention dropout)."""
        cfg, tp = self.cfg, self.tp
        dt = cfg.dtype
        h, dk, d_model = cfg.n_heads // (tp.size if tp else 1), cfg.d_head, cfg.d_model
        b, t, _ = x.shape
        x = copy_to_tp(x, tp)
        q = _linear(self.linear_q, x, dt).reshape(b, t, h, dk)
        k = _linear(self.linear_k, x, dt).reshape(b, t, h, dk)
        v = _linear(self.linear_v, x, dt).reshape(b, t, h, dk)
        q = q.to(torch.float32)
        qu = (q + self.pos_bias_u).to(dt)
        qv = (q + self.pos_bias_v).to(dt)

        use_decomposition = cfg.dropout_emb == 0.0
        if use_decomposition:
            # W_pos is [D_out, D_in] (torch layout); the JAX kernel is its
            # transpose, [e, (h, d)]
            w = self.linear_pos.weight.t().to(dt).reshape(d_model, h, dk)
            sin_t, cos_t = sin_cos  # [T, D/2]
            w_cat = torch.cat([w[0::2], w[1::2]], dim=0)  # [D, H, dk]
            qsc = torch.einsum("bihd,ehd->bhie", qv, w_cat)  # [B, H, T, D]
            qs, qc = qsc[..., : d_model // 2], qsc[..., d_model // 2 :]
            mod_a = qs * sin_t + qc * cos_t
            mod_b = -qs * cos_t + qc * sin_t

        if self.use_flash(t, lengths):
            # Qs = [q+u | mod_a | mod_b], Ks = [k | cos | sin] per head, in
            # batch-major (b*H + h) order; lens repeat per head
            qs_full = torch.cat([qu.permute(0, 2, 1, 3), mod_a, mod_b], dim=-1)
            cs = torch.cat([cos_t, sin_t], dim=-1).expand(b, h, t, d_model)
            ks_full = torch.cat([k.permute(0, 2, 1, 3), cs], dim=-1)
            d1 = dk + d_model
            o = flash_attention(
                qs_full.reshape(b * h, t, d1).contiguous(),
                ks_full.reshape(b * h, t, d1).contiguous(),
                v.permute(0, 2, 1, 3).reshape(b * h, t, dk).contiguous(),
                torch.repeat_interleave(lengths.to(torch.int32), h),
                1.0 / math.sqrt(dk), *(int(a) for a in cfg.att_context_size))
            out = o.reshape(b, h, t, dk).permute(0, 2, 1, 3).reshape(b, t, h * dk)
            valid = torch.arange(t, device=x.device)[None, :, None] < lengths[:, None, None]
            out = torch.where(valid, out, torch.zeros((), dtype=out.dtype, device=out.device))
            return _row_linear(self.linear_out.weight, self.linear_out.bias, out, dt, tp)

        # dense-score path
        matrix_ac = torch.einsum("bthd,bshd->bhts", qu, k)
        if use_decomposition:
            matrix_bd = (torch.einsum("bhik,jk->bhij", mod_a, cos_t)
                         + torch.einsum("bhik,jk->bhij", mod_b, sin_t))
        else:
            p = _linear(self.linear_pos, pos_emb, dt).reshape(-1, h, dk)
            matrix_bd = torch.einsum("bthd,phd->bhtp", qv, p)
            matrix_bd = _rel_shift(matrix_bd)[..., :t]
        scores = (matrix_ac.to(torch.float32) + matrix_bd.to(torch.float32)) / math.sqrt(dk)
        masked = att_mask[:, None, :, :]
        scores = scores.masked_fill(masked, -10000.0)
        attn = torch.softmax(scores, dim=-1).masked_fill(masked, 0.0).to(dt)
        attn = fast_dropout(attn, cfg.dropout_att, shard_seed(seed, tp))
        out = torch.einsum("bhts,bshd->bthd", attn, v).reshape(b, t, h * dk)
        return _row_linear(self.linear_out.weight, self.linear_out.bias, out, dt, tp)


class AbsPosMultiHeadAttention(nn.Module):
    TENSOR_PARALLEL = True
    tp = None

    def __init__(self, cfg: ConformerEncoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.linear_q = nn.Linear(d, d)
        self.linear_k = nn.Linear(d, d)
        self.linear_v = nn.Linear(d, d)
        self.linear_out = nn.Linear(d, d)

    def forward(self, x, att_mask, seed=None):
        cfg, tp = self.cfg, self.tp
        dt, h, dk = cfg.dtype, cfg.n_heads // (tp.size if tp else 1), cfg.d_head
        b, t, _ = x.shape
        x = copy_to_tp(x, tp)
        q = _linear(self.linear_q, x, dt).reshape(b, t, h, dk)
        k = _linear(self.linear_k, x, dt).reshape(b, t, h, dk)
        v = _linear(self.linear_v, x, dt).reshape(b, t, h, dk)
        scores = torch.einsum("bthd,bshd->bhts", q, k).to(torch.float32) / math.sqrt(dk)
        masked = att_mask[:, None, :, :]
        scores = scores.masked_fill(masked, -10000.0)
        attn = torch.softmax(scores, dim=-1).masked_fill(masked, 0.0)
        attn = fast_dropout(attn, cfg.dropout_att, shard_seed(seed, tp))  # fp32, as JAX's
        out = torch.einsum("bhts,bshd->bthd", attn.to(dt), v).reshape(b, t, h * dk)
        return _row_linear(self.linear_out.weight, self.linear_out.bias, out, dt, tp)


class ConformerFeedForward(nn.Module):
    """linear1 (column-parallel under `tp`) -> swish -> dropout -> linear2
    (row-parallel)."""

    TENSOR_PARALLEL = True
    tp = None

    def __init__(self, cfg: ConformerEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.linear1 = nn.Linear(cfg.d_model, cfg.d_ff)
        self.linear2 = nn.Linear(cfg.d_ff, cfg.d_model)

    def forward(self, x, seed=None):
        dt, tp = self.cfg.dtype, self.tp
        y = _linear(self.linear1, copy_to_tp(x, tp), dt)
        y = fast_dropout(F.silu(y), self.cfg.dropout, shard_seed(seed, tp))
        return _row_linear(self.linear2.weight, self.linear2.bias, y, dt, tp)


def _tp_layer_norm(norm: nn.LayerNorm, x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """A LayerNorm over channels that the model group shards: x [B, T, C / model]
    holds this rank's channels and `norm` their weight and bias. The mean
    and variance come from the sum and sum of squares over every rank's
    channels (one all-reduce of [2, B, T] in fp32, whose backward sums the
    ranks' gradients), with flax's E[x^2] - E[x]^2 variance clipped at 0;
    each rank normalises its own channels."""
    x = x.to(torch.float32)
    c = x.shape[-1] * tp.size
    sums = all_reduce_sum(torch.stack([x.sum(dim=-1), (x * x).sum(dim=-1)]), tp.group)
    mean = sums[0] / c
    var = torch.clamp(sums[1] / c - mean * mean, min=0.0)
    y = (x - mean[..., None]) * torch.rsqrt(var + norm.eps)[..., None]
    return y * norm.weight + norm.bias


class ConformerConvolution(nn.Module):
    """pointwise(2d) -> GLU -> pad-masked depthwise(k) -> norm -> swish -> pointwise.
    Under `tp`: pointwise_conv1 column-parallel on each GLU half, the
    depthwise conv and the norm by channel (a BatchNorm's statistics are per
    channel; a LayerNorm's come from every rank's channels,
    `_tp_layer_norm`), pointwise_conv2 row-parallel."""

    TENSOR_PARALLEL = True
    tp = None

    def __init__(self, cfg: ConformerEncoderConfig):
        super().__init__()
        d, k = cfg.d_model, cfg.conv_kernel_size
        self.cfg = cfg
        self.pointwise_conv1 = nn.Conv1d(d, 2 * d, 1)
        self.depthwise_conv = nn.Conv1d(d, d, k, groups=d, padding=(k - 1) // 2)
        # NeMo names the norm 'batch_norm' for both norm types
        self.batch_norm = BatchNorm(d) if cfg.conv_norm_type == "batch_norm" else _layer_norm(d)
        self.pointwise_conv2 = nn.Conv1d(d, d, 1)

    def forward(self, x, pad_mask):
        """-> (y, BatchNorm batch statistics or None)."""
        dt, tp = self.cfg.dtype, self.tp
        pw1, pw2, dw = self.pointwise_conv1, self.pointwise_conv2, self.depthwise_conv
        x = copy_to_tp(x, tp)
        x = F.linear(x.to(dt), pw1.weight[..., 0].to(dt), pw1.bias.to(dt))
        a, gate = x.chunk(2, dim=-1)
        x = a * torch.sigmoid(gate)  # GLU
        # zero padded frames so no padding leaks into valid ones
        x = x.masked_fill(pad_mask[:, :, None], 0.0)
        x = F.conv1d(x.transpose(1, 2), dw.weight.to(dt), dw.bias.to(dt),
                     padding=dw.padding, groups=dw.weight.shape[0])  # [B, D, T]
        stats = None
        if isinstance(self.batch_norm, BatchNorm):
            x, stats = self.batch_norm(x)
            x = x.transpose(1, 2)
        elif tp is None:
            x = _fp32_norm(self.batch_norm, x.transpose(1, 2))
        else:
            x = _tp_layer_norm(self.batch_norm, x.transpose(1, 2), tp)
        x = F.silu(x)
        return _row_linear(pw2.weight[..., 0], pw2.bias, x, dt, tp), stats


# dropout sites of a layer (sub-seeds of the layer's seed)
_FF1_HIDDEN, _FF1_OUT, _ATT_PROBS, _ATT_OUT, _CONV_OUT, _FF2_HIDDEN, _FF2_OUT = range(7)


class ConformerLayer(nn.Module):
    """half-FF -> MHSA -> conv -> half-FF -> LayerNorm (macaron, fc_factor=0.5)."""

    def __init__(self, cfg: ConformerEncoderConfig, shared_biases=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.norm_feed_forward1 = _layer_norm(d)
        self.feed_forward1 = ConformerFeedForward(cfg)
        self.norm_self_att = _layer_norm(d)
        if cfg.self_attention_model == "rel_pos":
            self.self_attn = RelPosMultiHeadAttention(cfg, shared_biases)
        else:
            self.self_attn = AbsPosMultiHeadAttention(cfg)
        self.norm_conv = _layer_norm(d)
        self.conv = ConformerConvolution(cfg)
        self.norm_feed_forward2 = _layer_norm(d)
        self.feed_forward2 = ConformerFeedForward(cfg)
        self.norm_out = _layer_norm(d)

    def forward(self, x, pos_emb, sin_cos, att_mask, pad_mask, lengths=None, seed=None):
        """-> (x, BatchNorm batch statistics or None). seed: the layer's
        dropout seed, None in eval mode."""
        cfg = self.cfg
        dt = cfg.dtype

        def to_res(y, site):
            # branch outputs round to the compute dtype (and drop there); the
            # residual stays fp32
            return fast_dropout(y.to(dt), cfg.dropout, sub_seed(seed, site)).to(torch.float32)

        residual = x
        y = self.feed_forward1(_fp32_norm(self.norm_feed_forward1, residual),
                               sub_seed(seed, _FF1_HIDDEN))
        residual = residual + to_res(y, _FF1_OUT) * 0.5
        y = _fp32_norm(self.norm_self_att, residual)
        if cfg.self_attention_model == "rel_pos":
            y = self.self_attn(y, pos_emb, sin_cos, att_mask, lengths=lengths,
                               seed=sub_seed(seed, _ATT_PROBS))
        else:
            y = self.self_attn(y, att_mask, seed=sub_seed(seed, _ATT_PROBS))
        residual = residual + to_res(y, _ATT_OUT)
        y, stats = self.conv(_fp32_norm(self.norm_conv, residual), pad_mask)
        residual = residual + to_res(y, _CONV_OUT)
        y = self.feed_forward2(_fp32_norm(self.norm_feed_forward2, residual),
                               sub_seed(seed, _FF2_HIDDEN))
        residual = residual + to_res(y, _FF2_OUT) * 0.5
        return _fp32_norm(self.norm_out, residual), stats


def _conv2d(mod: nn.Conv2d, y: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """nn.Conv2d in the compute dtype (params stay fp32)."""
    return F.conv2d(y.to(dt), mod.weight.to(dt), mod.bias.to(dt), stride=mod.stride,
                    padding=mod.padding)


class _ResNetBlock(nn.Module):
    """The fork's ResNetBlock: two 3x3 convolutions, each added to its input
    (the first block's 1-channel input broadcasts over C) and followed by a
    2-D BatchNorm and ReLU."""

    def __init__(self, in_ch: int, ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, ch, 3, stride=1, padding=1)
        self.batchnorm1 = BatchNorm(ch)
        self.conv2 = nn.Conv2d(ch, ch, 3, stride=1, padding=1)
        self.batchnorm2 = BatchNorm(ch)

    def forward(self, y, dt, stats: list):
        for conv, bn in ((self.conv1, self.batchnorm1), (self.conv2, self.batchnorm2)):
            y, st = bn(y + _conv2d(conv, y, dt))
            y = F.relu(y).to(dt)
            stats.append((bn, st))
        return y


class _SEEncoderLayer(nn.Module):
    """The fork's SEEncoderLayer: a 4x4 stride-2 convolution + BatchNorm +
    ReLU, then two residual 3x3 convolutions, each + BatchNorm + ReLU."""

    def __init__(self, in_ch: int, ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, ch, 4, stride=2, padding=1)
        self.batchnorm1 = BatchNorm(ch)
        self.conv2 = nn.Conv2d(ch, ch, 3, stride=1, padding=1)
        self.batchnorm2 = BatchNorm(ch)
        self.conv3 = nn.Conv2d(ch, ch, 3, stride=1, padding=1)
        self.batchnorm3 = BatchNorm(ch)

    def forward(self, y, dt, stats: list):
        for conv, bn in ((self.conv1, self.batchnorm1), (self.conv2, self.batchnorm2),
                         (self.conv3, self.batchnorm3)):
            z = _conv2d(conv, y, dt)
            y, st = bn(z if conv is self.conv1 else y + z)
            y = F.relu(y).to(dt)
            stats.append((bn, st))
        return y


class ConvSubsampling(nn.Module):
    """The conv front ends, log2(f) repetitions each, with NeMo's module
    indices in `conv`, then Linear over the flattened (C, F') axes, c-major
    as NeMo flattens them:

      striding:   [Conv2d k3 s2 p1, ReLU]                   (conv.{2j})
      vggnet:     [Conv2d k3 s1 p1, ReLU, Conv2d k3 s1 p1, ReLU,
                   MaxPool2d k2 s2 ceil]                     (conv.{5j}, conv.{5j+2})
      resnet:     [ResNetBlock, MaxPool2d k2 s2 ceil]       (conv.{2j})
      subencoder: [SEEncoderLayer]                          (conv.{j})

    The max pool with ceil_mode is the JAX package's -inf padding to an
    even size and a 2x2 pool. `forward` returns the front end's BatchNorm
    statistics beside the output (training mode), for the encoder to apply."""

    def __init__(self, cfg: ConformerEncoderConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.mode = mode = cfg.subsampling
        channels = cfg.subsampling_conv_channels if cfg.subsampling_conv_channels > 0 else cfg.d_model
        reps = int(math.log2(cfg.subsampling_factor))
        layers: list[nn.Module] = []
        in_ch = 1
        for _ in range(reps):
            if mode == "striding":
                layers += [nn.Conv2d(in_ch, channels, 3, stride=2, padding=1), nn.ReLU()]
            elif mode == "vggnet":
                layers += [nn.Conv2d(in_ch, channels, 3, stride=1, padding=1), nn.ReLU(),
                           nn.Conv2d(channels, channels, 3, stride=1, padding=1), nn.ReLU(),
                           nn.MaxPool2d(2, 2, ceil_mode=True)]
            elif mode == "resnet":
                layers += [_ResNetBlock(in_ch, channels), nn.MaxPool2d(2, 2, ceil_mode=True)]
            else:
                layers += [_SEEncoderLayer(in_ch, channels)]
            in_ch = channels
        self.conv = nn.Sequential(*layers)
        self.out = nn.Linear(channels * freq_out(cfg), cfg.d_model)

    def forward(self, x):
        """x [B, T, F] -> (y [B, T', d_model], [(BatchNorm, batch statistics)])."""
        dt = self.dtype
        y = x[:, None, :, :].to(dt)  # [B, 1, T, F]
        stats: list = []
        for mod in self.conv:
            if isinstance(mod, nn.Conv2d):
                y = _conv2d(mod, y, dt)
            elif isinstance(mod, nn.ReLU):
                y = F.relu(y)
            elif isinstance(mod, nn.MaxPool2d):
                y = F.max_pool2d(y, 2, 2, ceil_mode=True)
            else:
                y = mod(y, dt, stats)
        b, c, t, f = y.shape
        y = y.transpose(1, 2).reshape(b, t, c * f)
        return _linear(self.out, y, dt), [(bn, st) for bn, st in stats if st is not None]


class StackingSubsampling(nn.Module):
    """Stacks f consecutive frames (T padded to a multiple of f, by a whole
    f when it already is one), then `proj_out` to d_model."""

    def __init__(self, cfg: ConformerEncoderConfig):
        super().__init__()
        self.dtype, self.factor = cfg.dtype, cfg.subsampling_factor
        self.proj_out = nn.Linear(cfg.feat_in * cfg.subsampling_factor, cfg.d_model)

    def forward(self, x):
        b, t, d = x.shape
        f = self.factor
        pad = _stacking_pad(f, t)
        x = F.pad(x, (0, 0, 0, pad)).reshape(b, (t + pad) // f, d * f)
        return _linear(self.proj_out, x, self.dtype), []


# encoder-level dropout sites (sub-seeds of the step's seed; layer i takes i)
_ENC_INPUT, _ENC_POS_EMB = -1, -2


class ConformerEncoder(nn.Module):
    """[B, D_feat, T] + lengths -> [B, d_model, T'] (fp32) + lengths'."""

    def __init__(self, cfg: ConformerEncoderConfig):
        super().__init__()
        self.cfg = cfg
        _check_mode(cfg)
        if uses_conv_subsampling(cfg):
            self.pre_encode = ConvSubsampling(cfg)
        elif cfg.subsampling == "stacking" and cfg.subsampling_factor > 1:
            self.pre_encode = StackingSubsampling(cfg)
        else:  # factor 1 / none: NeMo's `pre_encode` Linear
            self.pre_encode = nn.Linear(cfg.feat_in, cfg.d_model)
        shared = None
        if not cfg.untie_biases and cfg.self_attention_model == "rel_pos":
            self.pos_bias_u = nn.Parameter(torch.zeros(cfg.n_heads, cfg.d_head))
            self.pos_bias_v = nn.Parameter(torch.zeros(cfg.n_heads, cfg.d_head))
            shared = (self.pos_bias_u, self.pos_bias_v)
        self.layers = nn.ModuleList([ConformerLayer(cfg, shared) for _ in range(cfg.n_layers)])
        if cfg.feat_out > 0 and cfg.feat_out != cfg.d_model:
            self.out_proj = nn.Linear(cfg.d_model, cfg.feat_out)
        else:
            self.out_proj = None

    def forward(self, features: torch.Tensor, lengths: torch.Tensor,
                dropout_seed: Optional[int] = None):
        """dropout_seed: the step's seed of every dropout mask, required in
        training mode when a dropout rate is set; ignored in eval mode."""
        cfg = self.cfg
        seed = dropout_seed if self.training else None
        if seed is None and self.training and max(cfg.dropout, cfg.dropout_att,
                                                   cfg.dropout_emb) > 0.0:
            raise ValueError("training mode with dropout needs a dropout_seed")
        x = features.transpose(1, 2)
        if isinstance(self.pre_encode, nn.Linear):
            x, pre_stats = _linear(self.pre_encode, x, cfg.dtype), []
        else:
            x, pre_stats = self.pre_encode(x)
        for bn, stats in pre_stats:
            bn.update_running_stats(stats)
        out_lengths = encoder_lengths(cfg, lengths, features.shape[-1])
        t = x.shape[1]
        x = x.to(torch.float32)
        if cfg.xscaling:
            x = x * math.sqrt(cfg.d_model)
        pos_emb = sin_cos = None
        if cfg.self_attention_model == "rel_pos":
            if cfg.dropout_emb > 0.0:  # only the rel_shift path reads it
                pos_emb = torch.from_numpy(sinusoidal_rel_pos_emb(t, cfg.d_model)).to(x.device)
                pos_emb = fast_dropout(pos_emb, cfg.dropout_emb, sub_seed(seed, _ENC_POS_EMB))
            else:  # built once per forward, shared by every layer
                sin_cos = sin_cos_tables(t, cfg.d_model, cfg.dtype, x.device)
        else:
            x = x + torch.from_numpy(sinusoidal_abs_pos_emb(t, cfg.d_model)).to(x.device)
        x = fast_dropout(x, cfg.dropout, sub_seed(seed, _ENC_INPUT))
        pad_mask, att_mask = make_masks(cfg, t, out_lengths)
        remat = cfg.remat and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            args = (x, pos_emb, sin_cos, att_mask, pad_mask, out_lengths, sub_seed(seed, i))
            if remat:
                # the recomputation in the backward draws the same masks (they
                # depend on the seed only) and its statistics are dropped
                x, stats = torch.utils.checkpoint.checkpoint(layer, *args, use_reentrant=False)
            else:
                x, stats = layer(*args)
            if stats is not None:
                layer.conv.batch_norm.update_running_stats(stats)
        if self.out_proj is not None:
            x = _linear(self.out_proj, x, cfg.dtype)
        return x.to(torch.float32).transpose(1, 2), out_lengths
