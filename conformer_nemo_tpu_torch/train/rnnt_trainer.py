"""RNN-T train and eval steps (port of conformer_nemo_tpu/train/rnnt_trainer.py).

A train step is: frontend (training mode), SpecAugment, the transducer
(dropout, training BatchNorm; the joint branch of `RNNTModel.forward`), the
loss as the mean nll over the rows with audio (the loader's zero rows weigh
0), the gradients, Gaussian variational noise on the prediction network's
(`decoder.*`) gradients from `variational_noise_start` on, the global norm,
and the optimizer update; with `skip_nan_grad` a step whose gradient norm
is not finite leaves parameters and optimizer state as they were. The
metrics carry the encoder's, decoder's and joint's gradient norms.

Randomness is explicit: the state's CPU generator draws four seeds per
step (frontend noise, augmentation, the model's dropout, variational
noise), and each seeds a generator on the model's device where tensors
are drawn.

On a mesh the step is the CTC step's (train/trainer.py): the weighted
mean over the global batch, gradients summed over the data group, the
full gradients' norm, one `skip_nan_grad` decision for every rank. The
frontend and augmentation seeds mix in the rank's data index; the model
takes the step's dropout seed with the data index and the rank's first
row in the global batch (the flash joint's hash); the variational noise
is drawn after the reduction from the step's seed, the same on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from conformer_nemo_tpu_torch.audio.features import MelFeatureConfig, log_mel_spectrogram
from conformer_nemo_tpu_torch.audio.spec_augment import (
    SpecAugmentConfig,
    apply_spectrogram_augmentation,
)
from conformer_nemo_tpu_torch.decode.rnnt_greedy import rnnt_greedy_decode_batched
from conformer_nemo_tpu_torch.decode.wer import wer_num_denom
from conformer_nemo_tpu_torch.models.conformer import rank_seed
from conformer_nemo_tpu_torch.models.rnnt import RNNTModel, RNNTModelConfig
from conformer_nemo_tpu_torch.parallel.distributed import host_psum_scalars
from conformer_nemo_tpu_torch.parallel.mesh import Mesh
from conformer_nemo_tpu_torch.train.optim import Transformation, apply_updates
from conformer_nemo_tpu_torch.train.trainer import TrainState, _device_batch, _seeded

MODULES = ("encoder", "decoder", "joint")


@dataclasses.dataclass(frozen=True)
class RNNTTrainConfig:
    preprocessor: MelFeatureConfig = MelFeatureConfig()
    spec_augment: SpecAugmentConfig = SpecAugmentConfig()
    model: RNNTModelConfig = RNNTModelConfig()
    variational_noise_std: float = 0.0
    variational_noise_start: int = 0


def init_rnnt_state(model: RNNTModel, optimizer: Transformation, seed: int = 0) -> TrainState:
    return TrainState(model=model, opt_state=optimizer.init(list(model.parameters())),
                      generator=torch.Generator().manual_seed(seed))


def _loss(cfg: RNNTTrainConfig, model: RNNTModel, feats, feat_lens, bd, dropout_seed=None,
          mesh: Optional[Mesh] = None):
    """sum(nll * w) / max(sum(w), 1), sum(w) over the mesh's data group."""
    mesh = mesh or Mesh()
    b = feats.shape[0]
    nll = model(feats, feat_lens, bd["tokens"], bd["token_lens"], dropout_seed=dropout_seed,
                data_index=mesh.data_index, row_offset=mesh.data_index * b)
    valid = (bd["audio_lens"] > 0).to(nll.dtype)
    return (nll * valid).sum() / torch.clamp(mesh.data_sum(valid.sum()), min=1.0)


def make_rnnt_train_step(cfg: RNNTTrainConfig, optimizer: Transformation,
                         skip_nan_grad: bool = False) -> Callable:
    """-> step(state, batch) -> {"loss", "grad_norm", "<module>_grad_norm"}
    (0-d tensors), which updates `state` in place."""

    def step(state: TrainState, batch) -> dict:
        model, mesh = state.model, state.mesh_or_single
        names, params = zip(*model.named_parameters())
        params = list(params)
        dev = params[0].device
        bd = _device_batch(batch, dev)
        feat_seed, aug_seed, drop_seed, noise_seed = (
            int(s) for s in torch.randint(0, 1 << 62, (4,), generator=state.generator))
        feat_seed, aug_seed = (rank_seed(s, mesh.data_index) for s in (feat_seed, aug_seed))
        model.train()
        with torch.no_grad():
            feats, feat_lens = log_mel_spectrogram(
                cfg.preprocessor, bd["audio"], bd["audio_lens"],
                generator=_seeded(dev, feat_seed), training=True)
            if cfg.spec_augment.enabled:
                feats = apply_spectrogram_augmentation(cfg.spec_augment, _seeded(dev, aug_seed),
                                                       feats, feat_lens)
        loss = _loss(cfg, model, feats, feat_lens, bd, dropout_seed=drop_seed, mesh=mesh)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        grads = mesh.reduce_grads(grads, params)
        if cfg.variational_noise_std > 0 and state.step >= cfg.variational_noise_start:
            noise_gen = _seeded(dev, noise_seed)
            grads = [g + cfg.variational_noise_std * torch.randn(
                         g.shape, generator=noise_gen, device=g.device, dtype=g.dtype)
                     if n.startswith("decoder.") else g for n, g in zip(names, grads)]
        gnorm = mesh.grad_norm(grads, params)
        if not skip_nan_grad or mesh.all_finite(gnorm):
            updates, state.opt_state = optimizer.update(grads, state.opt_state, params)
            apply_updates(params, updates)
        state.step += 1
        metrics = {"loss": mesh.data_sum(loss.detach()), "grad_norm": gnorm}
        for mod in MODULES:
            picked = [i for i, n in enumerate(names) if n.startswith(mod + ".")]
            metrics[f"{mod}_grad_norm"] = mesh.grad_norm([grads[i] for i in picked],
                                                         [params[i] for i in picked])
        return metrics

    return step


def _eval_features(cfg: RNNTTrainConfig, model: RNNTModel, batch):
    dev = next(model.parameters()).device
    bd = _device_batch(batch, dev)
    model.eval()
    feats, feat_lens = log_mel_spectrogram(cfg.preprocessor, bd["audio"], bd["audio_lens"])
    return bd, feats, feat_lens


def make_rnnt_eval_step(cfg: RNNTTrainConfig, max_symbols: int = 10) -> Callable:
    """-> eval(model, batch) -> (tokens, token_lens, enc_lens): encoder and
    batched greedy decode in eval mode."""

    @torch.no_grad()
    def eval_fn(model: RNNTModel, batch):
        _, feats, feat_lens = _eval_features(cfg, model, batch)
        enc, enc_lens = model.encode(feats, feat_lens)
        tokens, lens = rnnt_greedy_decode_batched(model, enc, enc_lens, max_symbols=max_symbols)
        return tokens, lens, enc_lens

    return eval_fn


def make_rnnt_loss_eval_step(cfg: RNNTTrainConfig) -> Callable:
    """-> loss(model, batch): the deterministic transducer loss for
    validation, built only when `compute_eval_loss` is set (the dense joint
    on long eval utterances is memory-hungry)."""

    @torch.no_grad()
    def loss_fn(model: RNNTModel, batch):
        bd, feats, feat_lens = _eval_features(cfg, model, batch)
        return _loss(cfg, model, feats, feat_lens, bd)

    return loss_fn


def evaluate_rnnt_wer(cfg: RNNTTrainConfig, model: RNNTModel, loader, tokenizer,
                      eval_step=None, use_cer: bool = False, loss_step=None,
                      mesh: Optional[Mesh] = None) -> dict:
    """Dataset WER of the greedy decode: sum(edits) / sum(words) across
    batches; with `loss_step`, the mean validation loss as well. On a mesh
    each rank reads its slice of the loader, and the counts are summed
    over the data group."""
    eval_step = eval_step or make_rnnt_eval_step(cfg)
    tot_e, tot_w, tot_loss, n_batches = 0, 0, 0.0, 0
    example = None
    for batch in loader:
        if loss_step is not None:
            tot_loss += float(loss_step(model, batch))
            n_batches += 1
        tokens, lens, _ = eval_step(model, batch)
        n_valid = int((batch.audio_lens > 0).sum())
        toks, lens = tokens.cpu().numpy(), lens.cpu().numpy()
        hyps = [tokenizer.ids_to_text(toks[i, : lens[i]].tolist()) for i in range(n_valid)]
        refs = batch.texts[:n_valid]
        e, w = wer_num_denom(hyps, refs, use_cer)
        tot_e += e
        tot_w += w
        if example is None and refs:
            example = (refs[0], hyps[0])
    if mesh is not None and mesh.distributed:
        tot = host_psum_scalars(mesh.data_group, edits=tot_e, words=tot_w, loss=tot_loss,
                                batches=n_batches)
        tot_e, tot_w, tot_loss, n_batches = (int(tot["edits"]), int(tot["words"]), tot["loss"],
                                             int(tot["batches"]))
    out = {"wer": tot_e / max(tot_w, 1), "edits": tot_e, "words": tot_w, "example": example}
    if n_batches:
        out["loss"] = tot_loss / n_batches
    return out
