"""CTC train and eval steps (port of conformer_nemo_tpu/train/trainer.py).

A train step is: frontend (training mode: dither, narrowband), then
SpecAugment, then the model (dropout, training BatchNorm), then the CTC
loss averaged over the rows with audio (the loader's zero rows weigh 0),
then the gradients, their global norm, and the optimizer update. With
`skip_nan_grad`, a step whose gradient norm is not finite leaves the
parameters and the optimizer state as they were; the step counter still
advances (the BatchNorm statistics of that forward stay updated, as in the
JAX package).

Randomness is explicit: the state's CPU `torch.Generator` draws three seeds
per step (frontend noise, augmentation, dropout), each of which seeds a
generator on the device or, for dropout, every mask of the step
(models/conformer.py).

On a mesh (`TrainState.mesh`, parallel/mesh.py) every rank runs the step
on its own rows. The loss is the JAX package's over the global batch,
sum(nll * w) / max(sum(w), 1), with sum(w) summed over the data group, so
that the gradients summed over the group (one coalesced all-reduce after
the backward) are the global batch's; the global norm and optax's
clipping read the full gradients, and `skip_nan_grad` decides once for
every rank. The generator is the same on every rank; each rank mixes its
data index into the step's seeds (`rank_seed`), so the two ranks of a
tensor-parallel pair draw the same masks and data-parallel ranks their own.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from conformer_nemo_tpu_torch.audio.features import log_mel_spectrogram
from conformer_nemo_tpu_torch.audio.spec_augment import apply_spectrogram_augmentation
from conformer_nemo_tpu_torch.decode.ctc_greedy import collapse_ctc_ids, ctc_greedy_decode
from conformer_nemo_tpu_torch.decode.wer import wer_num_denom
from conformer_nemo_tpu_torch.models.conformer import rank_seed
from conformer_nemo_tpu_torch.models.ctc_model import CTCModel, CTCModelConfig, ctc_model_loss
from conformer_nemo_tpu_torch.parallel.distributed import host_psum_scalars
from conformer_nemo_tpu_torch.parallel.mesh import Mesh
from conformer_nemo_tpu_torch.parallel.sharding import (
    gather_opt_state,
    set_sync_batchnorm,
    shard_model_,
    shard_opt_state,
    unshard_model_,
)
from conformer_nemo_tpu_torch.train.optim import Transformation, apply_updates

_BATCH_KEYS = ("audio", "audio_lens", "tokens", "token_lens")


@dataclasses.dataclass
class TrainState:
    model: CTCModel
    opt_state: dict
    generator: torch.Generator  # CPU; draws each step's seeds
    step: int = 0
    mesh: Optional[Mesh] = None  # None: one process

    @property
    def mesh_or_single(self) -> Mesh:
        return self.mesh or Mesh()

    @property
    def params(self) -> list:
        return list(self.model.parameters())


def init_ctc_state(model: CTCModel, optimizer: Transformation, seed: int = 0) -> TrainState:
    return TrainState(model=model, opt_state=optimizer.init(list(model.parameters())),
                      generator=torch.Generator().manual_seed(seed))


def distribute_state(state: TrainState, mesh: Mesh) -> None:
    """Put a train state on the mesh: the encoder and the optimizer's
    moments cut to this rank's slices (model axis), BatchNorm statistics
    synchronised over the data group."""
    state.mesh = mesh if mesh.distributed else None
    if mesh.model > 1:
        shard_model_(state.model, mesh)
        state.opt_state = shard_opt_state(state.opt_state, state.model)
    set_sync_batchnorm(state.model, mesh.data_group)


def undistribute_state(state: TrainState) -> None:
    """The full model and optimizer state back on every rank (collective
    when sharded), the BatchNorm local again."""
    state.opt_state = gather_opt_state(state.opt_state, state.model)
    unshard_model_(state.model)
    set_sync_batchnorm(state.model, None)
    state.mesh = None


def run_epochs(state: TrainState, step_fn: Callable, epoch_batches: Callable, max_epochs: int,
               max_steps: Optional[int] = None, after_step: Optional[Callable] = None,
               after_epoch: Optional[Callable] = None) -> tuple:
    """The epoch loop of every model's `fit`: `step_fn(batch)` over the
    batches of `epoch_batches()` (a context manager that gives one epoch's
    iterable and closes it when the epoch ends or is cut), for up to
    `max_epochs` epochs, until `state.step` reaches `max_steps` (when given)
    or `after_step(step, metrics)` returns True. `after_epoch(step)` runs at
    the end of each epoch that `after_step` did not stop, the one that
    max_steps cut included. The model is in eval mode again on return.
    -> (the last step's metrics, {} when none ran; whether after_step stopped)."""
    metrics: dict = {}
    try:
        for _ in range(max_epochs):
            stopped = False
            with epoch_batches() as batches:
                for batch in batches:
                    metrics = step_fn(batch)
                    if after_step is not None and after_step(state.step, metrics):
                        stopped = True
                        break
                    if max_steps and state.step >= max_steps:
                        break
            if stopped:
                return metrics, True
            if after_epoch is not None:
                after_epoch(state.step)
            if max_steps and state.step >= max_steps:
                break
        return metrics, False
    finally:
        state.model.eval()


def _device_batch(batch, device) -> dict:
    """A Batch or dict of numpy arrays / tensors -> dict of tensors on
    device. `fit` hands the step batches that data/prefetch.py already put
    on the device (then nothing is copied here); a direct caller's numpy
    batch is copied synchronously."""
    get = batch.__getitem__ if isinstance(batch, dict) else lambda k: getattr(batch, k)
    return {k: torch.as_tensor(get(k)).to(device) for k in _BATCH_KEYS}


def _seeded(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def make_ctc_train_step(cfg: CTCModelConfig, optimizer: Transformation,
                        skip_nan_grad: bool = False, ctc_impl: str = "auto") -> Callable:
    """-> step(state, batch) -> {"loss", "grad_norm"} (0-d tensors), which
    updates `state` in place."""

    def step(state: TrainState, batch) -> dict:
        model, mesh = state.model, state.mesh_or_single
        params = state.params
        dev = params[0].device
        bd = _device_batch(batch, dev)
        feat_seed, aug_seed, drop_seed = (
            rank_seed(int(s), mesh.data_index)
            for s in torch.randint(0, 1 << 62, (3,), generator=state.generator))
        model.train()
        with torch.no_grad():
            feats, feat_lens = log_mel_spectrogram(
                cfg.preprocessor, bd["audio"], bd["audio_lens"],
                generator=_seeded(dev, feat_seed), training=True)
            if cfg.spec_augment.enabled:
                feats = apply_spectrogram_augmentation(cfg.spec_augment, _seeded(dev, aug_seed),
                                                       feats, feat_lens)
        log_probs, enc_lens = model(feats, feat_lens, dropout_seed=drop_seed)
        valid = (bd["audio_lens"] > 0).to(torch.float32)
        loss = ctc_model_loss(cfg, log_probs, enc_lens, bd["tokens"], bd["token_lens"], valid,
                              impl=ctc_impl, denominator=mesh.data_sum(valid.sum()))
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        grads = mesh.reduce_grads(grads, params)
        gnorm = mesh.grad_norm(grads, params)
        if not skip_nan_grad or mesh.all_finite(gnorm):
            updates, state.opt_state = optimizer.update(grads, state.opt_state, params)
            apply_updates(params, updates)
        state.step += 1
        return {"loss": mesh.data_sum(loss.detach()), "grad_norm": gnorm}

    return step


def make_ctc_eval_step(cfg: CTCModelConfig) -> Callable:
    """-> eval(model, batch) -> (loss, greedy ids [B, T'], enc_lens [B]) in
    eval mode; on CUDA the loss takes the forward-only K1 kernel."""

    @torch.no_grad()
    def eval_fn(model: CTCModel, batch):
        dev = next(model.parameters()).device
        bd = _device_batch(batch, dev)
        model.eval()
        feats, feat_lens = log_mel_spectrogram(cfg.preprocessor, bd["audio"], bd["audio_lens"])
        log_probs, enc_lens = model(feats, feat_lens)
        valid = (bd["audio_lens"] > 0).to(torch.float32)
        loss = ctc_model_loss(cfg, log_probs, enc_lens, bd["tokens"], bd["token_lens"], valid)
        return loss, ctc_greedy_decode(log_probs), enc_lens

    return eval_fn


def evaluate_wer(cfg: CTCModelConfig, model: CTCModel, loader, tokenizer,
                 mesh: Optional[Mesh] = None) -> dict:
    """Dataset WER: greedy decode on the device, detokenise and edit
    distance on the host; sum(edits) / sum(words) across batches. On a
    mesh each rank reads its slice of the loader, and the edits, words,
    loss and batch counts are summed over the data group."""
    eval_step = make_ctc_eval_step(cfg)
    tot_edits, tot_words, tot_loss, n_batches = 0, 0, 0.0, 0
    example = None  # one (reference, prediction) pair
    for batch in loader:
        loss, preds, enc_lens = eval_step(model, batch)
        n_valid = int((batch.audio_lens > 0).sum())
        id_lists = collapse_ctc_ids(preds.cpu().numpy(), enc_lens.cpu().numpy(),
                                    cfg.blank_id)[:n_valid]
        hyps = [tokenizer.ids_to_text(ids) for ids in id_lists]
        refs = batch.texts[:n_valid]
        e, w = wer_num_denom(hyps, refs)
        tot_edits += e
        tot_words += w
        tot_loss += float(loss)
        n_batches += 1
        if example is None and refs:
            example = (refs[0], hyps[0])
    if mesh is not None and mesh.distributed:
        tot = host_psum_scalars(mesh.data_group, edits=tot_edits, words=tot_words,
                                loss=tot_loss, batches=n_batches)
        tot_edits, tot_words, tot_loss, n_batches = (
            int(tot["edits"]), int(tot["words"]), tot["loss"], int(tot["batches"]))
    return {"wer": tot_edits / max(tot_words, 1), "loss": tot_loss / max(n_batches, 1),
            "edits": tot_edits, "words": tot_words, "example": example}
