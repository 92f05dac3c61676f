"""RNN-T prediction network, joint and transducer model (port of
conformer_nemo_tpu/models/rnnt.py).

Parameter names are NeMo's, so a NeMo state_dict loads as it is
(convert/jax_params.py `rnnt_state_dict_from_jax` bridges the JAX
package's variables):

    decoder.prediction.embed.weight                    [V+1, H]
    decoder.prediction.dec_rnn.lstm.weight_ih_l{k}     [4H, in]   gates i, f, g, o
    decoder.prediction.dec_rnn.lstm.weight_hh_l{k}     [4H, H]
    decoder.prediction.dec_rnn.lstm.bias_ih_l{k}, bias_hh_l{k}
    joint.enc, joint.pred                              Linear to the joint width
    joint.joint_net.2                                  Linear to V+1 (after activation, dropout)

The LSTM trains one bias per layer, `bias_l{k}`, and it is the JAX
package's leaf: NeMo's bias less c in the forget chunk, where c is
`forget_gate_bias` (0 when `t_max` is set), which the cell adds to the
forget gate at run time as the JAX `_cell` does. (Two trainable biases
would each take the full gradient: the global norm would count it twice
and Adam would move their sum twice as far; and a leaf that held c would
decay c under weight decay, which the JAX package's leaf does not.) The
state_dict keeps NeMo's convention: it writes the leaf plus c in the
forget chunk as bias_ih and zeros as bias_hh, and loading sums the pair
and subtracts c. A train-state checkpoint carries the leaf itself beside
the state_dict (train/checkpoint.py), since fl(b + c) - c need not be b.

The LSTM cell is written out as the JAX package's `_cell`: the
products in the compute dtype, c and h in fp32 (cuDNN's LSTM rounds
differently in bf16), with the input projection of the whole sequence
hoisted out of the recursion. Layer-norm LSTM parameters, where configured,
are `dec_rnn.lstm.ln_{i,h,c}_l{k}.{weight,bias}`.

`RNNTModel.forward` returns the per-sample nll through one of the JAX
package's three joint branches: the flash joint (K4 + K3,
ops/rnnt_fused.py), the `fused_batch_size` sub-batched dense joint, or the
whole-batch dense joint (ops/rnnt_loss.py, K3 on CUDA). Randomness is
explicit: one per-step `dropout_seed` seeds a host generator that draws
the encoder's mask seed, the flash joint's hash seed and the seed of a
generator on the model's device, which draws the prediction network's and
the dense joint's masks where the tensors live. Under data parallelism
every rank takes the step's seed; the torch-drawn masks mix in the rank's
data index, and the flash joint's hash takes the rank's row offset.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from conformer_nemo_tpu_torch.models.conformer import (
    ConformerEncoder,
    ConformerEncoderConfig,
    _linear,
    rank_seed,
)
from conformer_nemo_tpu_torch.ops.rnnt_fused import rnnt_loss_fused
from conformer_nemo_tpu_torch.ops.rnnt_joint import KERNELS as JOINT_KERNELS
from conformer_nemo_tpu_torch.ops.rnnt_joint import ACTIVATIONS, check_smem, joint_seed
from conformer_nemo_tpu_torch.ops.rnnt_loss import rnnt_loss_from_logits


logger = logging.getLogger(__name__)
# (H, V) for which "auto" took the dense joint because the flash joint's
# kernels cannot take H, said once each
_DENSE_FOR_WIDTH: set = set()


@dataclasses.dataclass(frozen=True)
class RNNTDecoderConfig:
    vocab_size: int = 128  # V; blank = V
    pred_hidden: int = 640
    pred_rnn_layers: int = 1
    dropout: float = 0.1
    blank_as_pad: bool = True
    forget_gate_bias: float = 1.0
    t_max: Optional[int] = None  # Chrono init; then no forget_gate_bias
    weights_init_scale: float = 1.0
    norm: Optional[str] = None  # None | "layer"
    random_state_sampling: bool = False
    dtype: Any = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class RNNTJointConfig:
    joint_hidden: int = 640
    activation: str = "relu"
    dropout: float = 0.1
    fuse_loss_wer: bool = True
    fused_batch_size: int = 16
    dtype: Any = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class RNNTModelConfig:
    encoder: ConformerEncoderConfig = ConformerEncoderConfig(n_layers=17)
    decoder: RNNTDecoderConfig = RNNTDecoderConfig()
    joint: RNNTJointConfig = RNNTJointConfig()
    fastemit_lambda: float = 0.0
    clamp: float = -1.0
    # lattice: "kernel" (K3) | "plain" | "auto" (kernel on CUDA, plain on the CPU)
    lattice_impl: str = "auto"
    # training joint: "dense" | "flash" (K4) | "auto": dense on the CPU; on
    # CUDA flash once the dense joint's transients (logits, their gradient
    # and one prep transient, in the compute dtype) would pass the threshold,
    # where the kernels take joint_hidden (`check_smem`)
    joint_impl: str = "auto"
    joint_flash_bt: int = 16  # the t-tile that lays out the flash joint's dropout index
    joint_flash_hbm_threshold: float = 5.0e9

    def resolved_lattice_impl(self, device) -> str:
        if self.lattice_impl == "auto":
            return "kernel" if torch.device(device).type == "cuda" else "plain"
        return self.lattice_impl

    def resolve_joint_impl(self, b: int, t: int, u1: int, device) -> str:
        """"auto" takes the flash joint only where its kernels take the
        joint's width H in the joint's dtype (`check_smem`: any H the
        forward's shared memory holds, 1376 in the 16-bit dtypes); elsewhere
        the dense joint, sub-batched where `fused_batch_size` says so, and a
        log line says why (once per H, V). An explicit "flash" is checked at
        construction (`check_joint`) and again before its forward."""
        if self.joint_impl != "auto":
            return self.joint_impl
        if torch.device(device).type != "cuda":
            return "dense"
        dense_bytes = 3 * 2 * b * t * u1 * self.num_classes_with_blank
        if dense_bytes <= self.joint_flash_hbm_threshold:
            return "dense"
        h, v = self.joint.joint_hidden, self.num_classes_with_blank
        try:
            check_smem(h, v, (0, 1, 2), self.joint.dtype)
        except (TypeError, ValueError) as e:
            if (h, v) not in _DENSE_FOR_WIDTH:
                _DENSE_FOR_WIDTH.add((h, v))
                logger.warning("joint_impl auto: the dense joint, since the flash joint's "
                               "kernels cannot take joint_hidden=%d (%s)", h, e)
            return "dense"
        return "flash"

    @property
    def blank_id(self) -> int:
        return self.decoder.vocab_size

    @property
    def num_classes_with_blank(self) -> int:
        return self.decoder.vocab_size + 1


def check_joint(cfg: RNNTModelConfig, device) -> None:
    """Refuse, before any work, a CUDA transducer whose flash joint no
    kernel takes: a joint dtype other than bf16, fp16 and fp32 where the
    flash path can run (joint_impl not dense), and with joint_impl flash a
    joint_hidden past the kernels' shared memory (`check_smem`; "auto" takes
    the dense joint there and says so)."""
    if torch.device(device).type != "cuda" or cfg.joint_impl == "dense":
        return
    h, v, dt = cfg.joint.joint_hidden, cfg.num_classes_with_blank, cfg.joint.dtype
    try:
        if dt not in JOINT_KERNELS:
            raise TypeError(f"the CUDA flash-joint kernels take "
                            f"{', '.join(map(str, JOINT_KERNELS))}")
        if cfg.joint_impl == "flash":
            check_smem(h, v, (0, 1, 2), dt)
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"this transducer's flash joint cannot run on CUDA in {dt} at joint_hidden={h}, "
            f"V={v}: {e}. Set model.joint.joint_impl=dense for the dense joint") from None


def _draw_seed(gen: torch.Generator) -> int:
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen))


def _dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """Standard dropout with keep probability 1 - rate, bits from `gen`, a
    generator on x's device (None: identity)."""
    if gen is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def forget_offset(cfg: RNNTDecoderConfig) -> float:
    """c, the constant the cell adds to the forget gate: forget_gate_bias,
    or 0 with Chrono's initialisation (t_max set), as the JAX `_cell`."""
    return 0.0 if cfg.t_max is not None else float(cfg.forget_gate_bias or 0.0)


class _LSTMParams(nn.Module):
    """The stacked LSTM's parameters: nn.LSTM's weight names and one trained
    bias per layer, `bias_l{k}` (the JAX package's leaf b - c), kept in the
    state_dict as NeMo's bias_ih_l{k} (the leaf + c in the forget chunk)
    and bias_hh_l{k} (zeros); loading sums the pair and subtracts c."""

    def __init__(self, cfg: RNNTDecoderConfig):
        super().__init__()
        h = cfg.pred_hidden
        self.layers = cfg.pred_rnn_layers
        self.hidden = h
        self.offset = forget_offset(cfg)
        for k in range(cfg.pred_rnn_layers):
            self.register_parameter(f"weight_ih_l{k}", nn.Parameter(torch.zeros(4 * h, h)))
            self.register_parameter(f"weight_hh_l{k}", nn.Parameter(torch.zeros(4 * h, h)))
            self.register_parameter(f"bias_l{k}", nn.Parameter(torch.zeros(4 * h)))
            if cfg.norm == "layer":
                for name, n in (("ln_i", 4 * h), ("ln_h", 4 * h), ("ln_c", h)):
                    self.add_module(f"{name}_l{k}", nn.LayerNorm(n, eps=1e-5))

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        h = self.hidden
        for k in range(self.layers):
            b = destination.pop(prefix + f"bias_l{k}").detach().clone()
            b[h: 2 * h] += self.offset
            destination[prefix + f"bias_ih_l{k}"] = b
            destination[prefix + f"bias_hh_l{k}"] = torch.zeros_like(b)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        h = self.hidden
        for k in range(self.layers):
            ih, hh = prefix + f"bias_ih_l{k}", prefix + f"bias_hh_l{k}"
            if ih in state_dict and hh in state_dict:
                b = state_dict.pop(ih) + state_dict.pop(hh)
                b[h: 2 * h] -= self.offset
                state_dict[prefix + f"bias_l{k}"] = b
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class _DecRNN(nn.Module):
    def __init__(self, cfg: RNNTDecoderConfig):
        super().__init__()
        self.lstm = _LSTMParams(cfg)


class _Prediction(nn.Module):
    def __init__(self, cfg: RNNTDecoderConfig):
        super().__init__()
        self.embed = nn.Embedding(cfg.vocab_size + 1, cfg.pred_hidden)
        self.dec_rnn = _DecRNN(cfg)


class PredictionNetwork(nn.Module):
    """Embedding + LSTM stack. Full sequence: targets [B, U] -> g [B, U+1, H]
    with the SOS (= blank, embedded as zeros) step first; decode step:
    step(last_label [B], state) -> (g [B, H], state), state = (h, c) each
    [L, B, H] fp32."""

    def __init__(self, cfg: RNNTDecoderConfig):
        super().__init__()
        if cfg.norm not in (None, "layer"):
            raise NotImplementedError(
                f"normalization_mode={cfg.norm!r} not supported (None | 'layer')")
        self.cfg = cfg
        self.prediction = _Prediction(cfg)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers: the embedding N(0, 1/H), xavier-
        uniform input weights, orthogonal recurrent weights, zero biases or
        Chrono's (forget = log U(1, t_max - 1), input = -forget), all scaled
        by weights_init_scale. forget_gate_bias is not in the leaf: the cell
        adds it."""
        cfg = self.cfg
        h = cfg.pred_hidden
        scale = float(cfg.weights_init_scale)
        self.prediction.embed.weight.normal_(0.0, 1.0 / math.sqrt(h), generator=generator)
        lstm = self.prediction.dec_rnn.lstm
        for k in range(cfg.pred_rnn_layers):
            w_ih, w_hh = getattr(lstm, f"weight_ih_l{k}"), getattr(lstm, f"weight_hh_l{k}")
            b = getattr(lstm, f"bias_l{k}")
            nn.init.xavier_uniform_(w_ih, generator=generator)
            nn.init.orthogonal_(w_hh, generator=generator)
            w_ih.mul_(scale)
            w_hh.mul_(scale)
            b.zero_()
            if cfg.t_max is not None:
                fb = torch.log(torch.empty(h).uniform_(1.0, float(cfg.t_max - 1),
                                                       generator=generator))
                b[h: 2 * h] = fb * scale
                b[:h] = -fb * scale

    def _embed(self, labels: torch.Tensor) -> torch.Tensor:
        v = self.cfg.vocab_size
        emb = self.prediction.embed(labels.long().clamp(0, v))
        if self.cfg.blank_as_pad:
            emb = torch.where((labels == v)[..., None], torch.zeros((), device=emb.device), emb)
        return emb

    def zero_state(self, batch: int, device=None):
        h = torch.zeros((self.cfg.pred_rnn_layers, batch, self.cfg.pred_hidden),
                        device=device or self.prediction.embed.weight.device)
        return h, torch.zeros_like(h)

    def _in_proj(self, layer: int, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        w = getattr(self.prediction.dec_rnn.lstm, f"weight_ih_l{layer}")
        return torch.matmul(x.to(dt), w.to(dt).t()).float()

    def _cell(self, layer: int, ig: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        """The JAX `_cell`: ig = x W_ih^T (precomputed), fp32 state, the
        forget gate's constant c added at run time."""
        cfg = self.cfg
        lstm = self.prediction.dec_rnn.lstm
        dt = cfg.dtype
        hg = torch.matmul(h.to(dt), getattr(lstm, f"weight_hh_l{layer}").to(dt).t()).float()
        b = getattr(lstm, f"bias_l{layer}")
        if cfg.norm == "layer":
            ln = lambda x, name: F.layer_norm(x, x.shape[-1:], getattr(lstm, f"{name}_l{layer}").weight,
                                              getattr(lstm, f"{name}_l{layer}").bias, 1e-5)
            z = ln(ig, "ln_i") + ln(hg, "ln_h") + b
        else:
            z = ig + hg + b
        i, f, g, o = z.chunk(4, dim=-1)
        new_c = torch.sigmoid(f + lstm.offset) * c + torch.sigmoid(i) * torch.tanh(g)
        if cfg.norm == "layer":
            new_c = ln(new_c, "ln_c")
        return torch.sigmoid(o) * torch.tanh(new_c), new_c

    def forward(self, targets: torch.Tensor, generator: Optional[torch.Generator] = None):
        """targets [B, U] -> g [B, U+1, H] fp32. `generator` (training only;
        on targets' device) draws the random initial state and the
        inter-layer dropout."""
        cfg = self.cfg
        b = targets.shape[0]
        sos = torch.full((b, 1), cfg.vocab_size, dtype=targets.dtype, device=targets.device)
        x = self._embed(torch.cat([sos, targets], dim=1))
        for layer in range(cfg.pred_rnn_layers):
            h = torch.zeros((b, cfg.pred_hidden), device=x.device)
            c = torch.zeros_like(h)
            if cfg.random_state_sampling and generator is not None:
                h = torch.randn(h.shape, generator=generator, device=x.device)
                c = torch.randn(c.shape, generator=generator, device=x.device)
            ig_all = self._in_proj(layer, x)  # hoisted: one product over all U+1 steps
            ys = []
            for step in range(ig_all.shape[1]):
                h, c = self._cell(layer, ig_all[:, step], h, c)
                ys.append(h)
            x = torch.stack(ys, dim=1)
            if layer < cfg.pred_rnn_layers - 1:
                x = _dropout(x, cfg.dropout, generator)
        return x

    def step(self, last_label: torch.Tensor, state):
        """Decode step: last_label [B] -> (g [B, H], new state)."""
        x = self._embed(last_label[:, None])[:, 0]
        h_all, c_all = state
        new_h, new_c = [], []
        for layer in range(self.cfg.pred_rnn_layers):
            h, c = self._cell(layer, self._in_proj(layer, x), h_all[layer], c_all[layer])
            new_h.append(h)
            new_c.append(c)
            x = h
        return x, (torch.stack(new_h), torch.stack(new_c))


class RNNTJoint(nn.Module):
    """enc -> H, pred -> H, broadcast add, activation, dropout, H -> V+1."""

    def __init__(self, cfg: RNNTJointConfig, enc_dim: int, pred_dim: int,
                 num_classes_with_blank: int):
        super().__init__()
        if cfg.activation not in ACTIVATIONS:
            raise ValueError(f"joint activation must be one of {ACTIVATIONS}")
        self.cfg = cfg
        self.enc = nn.Linear(enc_dim, cfg.joint_hidden)
        self.pred = nn.Linear(pred_dim, cfg.joint_hidden)
        act = {"relu": nn.ReLU(), "sigmoid": nn.Sigmoid(), "tanh": nn.Tanh()}[cfg.activation]
        self.joint_net = nn.Sequential(act, nn.Dropout(cfg.dropout),
                                       nn.Linear(cfg.joint_hidden, num_classes_with_blank))

    @property
    def out(self) -> nn.Linear:
        return self.joint_net[2]

    def project(self, enc: torch.Tensor, pred: torch.Tensor):
        dt = self.cfg.dtype
        return _linear(self.enc, enc, dt), _linear(self.pred, pred, dt)

    def combine(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """x = e + p (compute dtype) -> logits: activation, the uint8-bits
        dropout (drop iff bits < round(rate * 256), rescale by the realised
        keep rate) when `generator` (on x's device) is given, then the
        output product."""
        cfg = self.cfg
        dt = cfg.dtype
        if cfg.activation == "relu":
            x = torch.relu(x)
        elif cfg.activation == "sigmoid":
            x = torch.sigmoid(x)
        else:
            x = torch.tanh(x)
        t = int(round(cfg.dropout * 256))
        if generator is not None and t > 0:
            bits = torch.randint(0, 256, x.shape, generator=generator, dtype=torch.uint8,
                                 device=x.device)
            x = torch.where(bits >= t, x / (1.0 - t / 256.0),
                            torch.zeros((), dtype=x.dtype, device=x.device))
        return torch.matmul(x.to(dt), self.out.weight.to(dt).t()) + self.out.bias.to(dt)

    def forward(self, enc: torch.Tensor, pred: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """enc [B, T, De] and pred [B, U, Dp] -> [B, T, U, V+1]; or [B, De]
        and [B, Dp] -> [B, V+1] (decode step)."""
        e, p = self.project(enc, pred)
        x = e[:, :, None, :] + p[:, None, :, :] if e.dim() == 3 else e + p
        return self.combine(x, generator)


class RNNTModel(nn.Module):
    """Encoder + prediction network + joint; forward -> per-sample nll [B]."""

    def __init__(self, cfg: RNNTModelConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = ConformerEncoder(cfg.encoder)
        enc = cfg.encoder
        d_out = enc.feat_out if enc.feat_out > 0 else enc.d_model
        self.decoder = PredictionNetwork(cfg.decoder)
        self.joint = RNNTJoint(cfg.joint, d_out, cfg.decoder.pred_hidden,
                               cfg.num_classes_with_blank)

    def encode(self, features, feat_lengths, dropout_seed: Optional[int] = None):
        encoded, enc_lens = self.encoder(features, feat_lengths, dropout_seed)
        return encoded.transpose(1, 2), enc_lens  # [B, T, D] fp32

    def forward(self, features, feat_lengths, targets, target_lengths,
                dropout_seed: Optional[int] = None, data_index: int = 0,
                row_offset: int = 0) -> torch.Tensor:
        """Training forward (dropout iff self.training, seeded by
        `dropout_seed`) -> per-sample RNN-T nll [B]. A data-parallel rank
        passes its data index, which gives its encoder and prediction
        network masks of their own (`rank_seed`), and the offset of its
        first row in the global batch, which places its rows in the flash
        joint's hash layout of the global batch (`joint_seed`)."""
        cfg = self.cfg
        gen = dev_gen = enc_seed = None
        if self.training and dropout_seed is not None:
            gen = torch.Generator().manual_seed(int(dropout_seed))  # host: seeds only
            enc_seed = rank_seed(_draw_seed(gen), data_index)
            dev_gen = torch.Generator(device=features.device).manual_seed(
                rank_seed(_draw_seed(gen), data_index))
        enc, enc_lens = self.encode(features, feat_lengths, enc_seed)
        g = self.decoder(targets, generator=dev_gen)
        dev = enc.device
        lattice = cfg.resolved_lattice_impl(dev)
        b = enc.shape[0]
        if cfg.resolve_joint_impl(b, enc.shape[1], g.shape[1], dev) == "flash":
            e, p = self.joint.project(enc, g)
            dt = cfg.joint.dtype
            drop_t = int(round(cfg.joint.dropout * 256)) if gen is not None else 0
            seed = joint_seed(_draw_seed(gen) if drop_t > 0 else 0, row_offset, enc.shape[1],
                              g.shape[1], cfg.joint.joint_hidden, cfg.joint_flash_bt)
            return rnnt_loss_fused(
                e.to(dt), p.to(dt), self.joint.out.weight.t().to(dt), self.joint.out.bias.to(dt),
                targets, enc_lens, target_lengths, seed, cfg.blank_id, cfg.fastemit_lambda,
                cfg.clamp, lattice, cfg.joint.activation, drop_t, cfg.joint_flash_bt)
        fused_bs = cfg.joint.fused_batch_size
        if cfg.joint.fuse_loss_wer and 0 < fused_bs < b and b % fused_bs == 0:
            # the dense joint a chunk of fused_bs samples at a time: peak
            # memory is one chunk's [b, T, U+1, V]
            e, p = self.joint.project(enc, g)
            nll = []
            for s in range(0, b, fused_bs):
                sl = slice(s, s + fused_bs)
                logits = self.joint.combine(e[sl, :, None, :] + p[sl, None, :, :], dev_gen)
                nll.append(rnnt_loss_from_logits(
                    logits, targets[sl], enc_lens[sl], target_lengths[sl], cfg.blank_id,
                    cfg.fastemit_lambda, cfg.clamp, lattice))
            return torch.cat(nll)
        logits = self.joint(enc, g, generator=dev_gen)
        return rnnt_loss_from_logits(logits, targets, enc_lens, target_lengths, cfg.blank_id,
                                     cfg.fastemit_lambda, cfg.clamp, lattice)
