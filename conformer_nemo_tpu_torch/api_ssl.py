"""Self-supervised pretraining of a Conformer encoder (port of
conformer_nemo_tpu/api_ssl.py): masked-spectrogram contrastive learning,
wav2vec style.

    model = SpeechSSLModel(encoder=enc_cfg, mel=mel_cfg,
                           loss=ContrastiveLossConfig(quantized_targets=True))  # CUDA
    model.fit("unlabeled.json", max_steps=1000)
    model.save_portable("ssl.cntpu")
    model.transfer_encoder_to(ctc_model)   # then ctc_model.fit(...)

A step: log-mel features (training mode: dither) -> optional feature
dropout -> masked patches (audio/spec_augment.py) -> the mask, detected as
the near-zero bins of the augmented spectrogram inside each row's length
-> encoder -> reconstruction decoder -> contrastive loss against the clean
spectrogram, plus the optional feature penalty (factor * mean(spec^2));
adamw at a constant rate, as the JAX package's `fit`. Randomness is
explicit: the train state's CPU generator draws each step's seeds
(features, feature dropout, patches, the loss's Gumbel draws, the
encoder's dropout). Manifests are ASR manifests; their texts are ignored.

Weights cross with the JAX package through `.cntpu` archives (`kind: ssl`;
convert/jax_params.py `ssl_variables_to_jax` / `ssl_state_dict_from_jax`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch
from torch import nn

from conformer_nemo_tpu_torch.api import init_weights
from conformer_nemo_tpu_torch.audio.features import (
    MelFeatureConfig,
    log_mel_spectrogram,
    mel_seq_len,
)
from conformer_nemo_tpu_torch.audio.spec_augment import masked_patch_augmentation
from conformer_nemo_tpu_torch.convert.jax_params import (
    ssl_state_dict_from_jax,
    ssl_variables_to_jax,
)
from conformer_nemo_tpu_torch.data.dataset import BucketedAudioTextDataset, BucketedLoader
from conformer_nemo_tpu_torch.data.manifest import read_manifest
from conformer_nemo_tpu_torch.data.prefetch import device_prefetch
from conformer_nemo_tpu_torch.data.tokenizers import CharTokenizer
from conformer_nemo_tpu_torch.device import resolve_device
from conformer_nemo_tpu_torch.models.conformer import (
    ConformerEncoder,
    ConformerEncoderConfig,
    check_flash_dtype,
    check_flash_training,
    encoder_lengths,
)
from conformer_nemo_tpu_torch.models.ssl import ReconstructionDecoder, ReconstructionDecoderConfig
from conformer_nemo_tpu_torch.ops.contrastive_loss import ContrastiveLoss, ContrastiveLossConfig
from conformer_nemo_tpu_torch.train.checkpoint import load_portable, save_portable
from conformer_nemo_tpu_torch.train.optim import apply_updates, constant_adamw
from conformer_nemo_tpu_torch.train.trainer import TrainState, _seeded, run_epochs


class SSLNet(nn.Module):
    """Encoder, reconstruction decoder and loss head in one module, so the
    loss's projection or quantizer trains with the rest (the JAX `_SSLNet`)."""

    def __init__(self, enc_cfg: ConformerEncoderConfig, dec_cfg: ReconstructionDecoderConfig,
                 loss_cfg: ContrastiveLossConfig):
        super().__init__()
        self.encoder = ConformerEncoder(enc_cfg)
        self.decoder_ssl = ReconstructionDecoder(dec_cfg)
        self.loss = ContrastiveLoss(loss_cfg)

    def forward(self, spectrograms, spec_masks, masked_feats, lengths, *, step: int,
                noise: Optional[dict] = None, generator: Optional[torch.Generator] = None,
                dropout_seed: Optional[int] = None) -> tuple:
        """-> (loss, decoder outputs [B, T_enc, proj_dim])."""
        enc, _ = self.encoder(masked_feats, lengths, dropout_seed=dropout_seed)
        dec_out = self.decoder_ssl(enc.transpose(1, 2))
        loss = self.loss(spectrograms, spec_masks, dec_out, step=step, train=self.training,
                         noise=noise, generator=generator)
        return loss, dec_out


def mask_inputs(spec: torch.Tensor, lengths: torch.Tensor, patch_size: int, mask_patches: int,
                dropout_features: float = 0.0, *, drop_generator=None, mask_generator=None,
                scores: Optional[torch.Tensor] = None) -> tuple:
    """Clean spec [B, D, T] -> (the masked encoder input, the loss's mask
    [B, D, T]): feature dropout (keep with probability 1 - p, scaled by
    1 / (1 - p)), the patches (`scores` may be given), and the mask as the
    augmented spectrogram's near-zero bins (|x| < 1e-5) inside each row's
    length, as the JAX step detects it."""
    feats = spec
    if dropout_features > 0:
        keep = torch.rand(spec.shape, generator=drop_generator,
                          device=spec.device) < 1.0 - dropout_features
        feats = torch.where(keep, spec / (1.0 - dropout_features), 0.0)
    masked = masked_patch_augmentation(feats, lengths, patch_size, mask_patches,
                                       generator=mask_generator, scores=scores)
    t = masked.shape[-1]
    in_len = (torch.arange(t, device=spec.device)[None, :] < lengths[:, None])[:, None, :]
    spec_masks = ((masked.abs() < 1e-5) & in_len).to(torch.float32)
    return masked, spec_masks


class SpeechSSLModel:
    """Masked-spectrogram contrastive pretraining of a Conformer encoder."""

    def __init__(self, encoder: Optional[ConformerEncoderConfig] = None,
                 mel: Optional[MelFeatureConfig] = None,
                 loss: Optional[ContrastiveLossConfig] = None,
                 decoder: Optional[ReconstructionDecoderConfig] = None,
                 patch_size: int = 48, mask_patches: int = 10, dropout_features: float = 0.0,
                 feature_penalty: float = 0.0, sample_rate: int = 16000, device=None,
                 seed: int = 0):
        self.device = resolve_device(device)
        self.mel = mel or MelFeatureConfig()
        self.enc_cfg = encoder or ConformerEncoderConfig(feat_in=self.mel.features)
        sub = self.enc_cfg.subsampling_factor if self.enc_cfg.subsampling != "none" else 1
        self.loss_cfg = loss or ContrastiveLossConfig(in_dim=self.mel.features,
                                                      combine_time_steps=sub)
        # the default decoder keeps encoder frames (combine_time_steps covers
        # the subsampling); stride_layers > 0 upsamples instead
        self.dec_cfg = decoder or ReconstructionDecoderConfig(
            feat_in=self.enc_cfg.d_model, feat_out=self.loss_cfg.proj_dim, stride_layers=0,
            dtype=self.enc_cfg.dtype)
        self.patch_size = patch_size
        self.mask_patches = mask_patches
        self.dropout_features = dropout_features
        self.feature_penalty = feature_penalty
        self.sample_rate = sample_rate
        self.seed = seed
        net = SSLNet(self.enc_cfg, self.dec_cfg, self.loss_cfg)
        gen = torch.Generator().manual_seed(seed)
        init_weights(net, gen)
        if self.loss_cfg.quantized_targets:
            net.loss.quantizer.reset_parameters(gen)
        self.model = net.to(self.device).eval()
        self.train_state: Optional[TrainState] = None

    # -- training -----------------------------------------------------------

    def loss(self, spec, lengths, masked, spec_masks, *, step: int, noise=None, generator=None,
             dropout_seed: Optional[int] = None) -> torch.Tensor:
        """The step's objective on prepared inputs (train mode): the
        contrastive loss plus the feature penalty of the clean spectrogram."""
        self.model.train()
        loss, _ = self.model(spec, spec_masks, masked, lengths, step=step, noise=noise,
                             generator=generator, dropout_seed=dropout_seed)
        if self.feature_penalty:
            loss = loss + self.feature_penalty * spec.square().mean()
        return loss

    def make_train_step(self, optimizer):
        """-> step(batch) -> {"loss"}, updating the train state in place."""

        def step_fn(batch) -> dict:
            state = self.train_state
            dev = self.device
            audio = torch.as_tensor(batch.audio).to(dev)
            lens = torch.as_tensor(batch.audio_lens).to(dev)
            feat_s, drop_s, mask_s, loss_s, model_s = (
                int(s) for s in torch.randint(0, 1 << 62, (5,), generator=state.generator))
            with torch.no_grad():
                spec, flens = log_mel_spectrogram(self.mel, audio, lens,
                                                  generator=_seeded(dev, feat_s), training=True)
                masked, spec_masks = mask_inputs(
                    spec, flens, self.patch_size, self.mask_patches, self.dropout_features,
                    drop_generator=_seeded(dev, drop_s), mask_generator=_seeded(dev, mask_s))
            params = state.params
            loss = self.loss(spec, flens, masked, spec_masks, step=state.step,
                             generator=_seeded(dev, loss_s), dropout_seed=model_s)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            updates, state.opt_state = optimizer.update(grads, state.opt_state, params)
            apply_updates(params, updates)
            state.step += 1
            return {"loss": loss.detach()}

        return step_fn

    def fit(self, train_manifest: str, max_steps: int = 100, max_epochs: int = 1000000,
            batch_size: int = 8, lr: float = 1e-3, weight_decay: float = 1e-3,
            log_every_n_steps: int = 20) -> dict:
        """-> {"steps", "time_s", "history": [{"step", "loss"}, ...]}; the
        model is in eval mode again on return."""
        samples = read_manifest(train_manifest)
        ds = BucketedAudioTextDataset(samples, CharTokenizer([" "]),
                                      sample_rate=self.sample_rate, n_buckets=4)
        loader = BucketedLoader(ds, batch_size, shuffle=True)
        longest = mel_seq_len(self.mel, torch.tensor([ds.boundaries[-1]]))
        check_flash_dtype(self.enc_cfg, self.device)
        check_flash_training(self.enc_cfg, self.device,
                             int(encoder_lengths(self.enc_cfg, longest, int(longest[0]))[0]))
        optimizer = constant_adamw(lr, weight_decay)
        if self.train_state is None:
            self.train_state = TrainState(
                model=self.model, opt_state=optimizer.init(list(self.model.parameters())),
                generator=torch.Generator().manual_seed(self.seed + 1))
        t0, history = time.time(), []

        def log_step(step: int, metrics: dict) -> None:
            if step % log_every_n_steps == 0 or step >= max_steps:
                history.append({"step": step, "loss": float(metrics["loss"])})

        run_epochs(self.train_state, self.make_train_step(optimizer),
                   lambda: contextlib.closing(device_prefetch(loader, self.device)),
                   max_epochs, max_steps, log_step)
        return {"steps": self.train_state.step, "time_s": time.time() - t0, "history": history}

    # -- transfer / persistence ---------------------------------------------

    def transfer_encoder_to(self, asr_model) -> None:
        """Copy the pretrained encoder into a ConformerCTC or
        ConformerTransducer of the same encoder config (the reference's
        init_from_nemo fine-tune flow); its optimizer state, if any, stays."""
        src = {k: tuple(v.shape) for k, v in self.model.encoder.state_dict().items()}
        dst = {k: tuple(v.shape) for k, v in asr_model.model.encoder.state_dict().items()}
        if src != dst:
            raise ValueError(
                "encoder configs differ between SSL and ASR models (parameter shapes do not "
                "match); use the same encoder config for pretraining and fine-tuning")
        asr_model.model.encoder.load_state_dict(self.model.encoder.state_dict())

    @property
    def portable_variables(self) -> dict:
        """The JAX `{"params", "batch_stats"}` tree (numpy) of this model."""
        return ssl_variables_to_jax(self.model.state_dict(), self.enc_cfg, self.dec_cfg,
                                    self.loss_cfg)

    def save_portable(self, path: str) -> None:
        save_portable(path, {"model": {"kind": "ssl"}}, self.portable_variables)

    def restore_weights(self, path: str) -> None:
        """Load an SSL `.cntpu` written by either package (same configs)."""
        _cfg, variables, _ = load_portable(path)
        sd = ssl_state_dict_from_jax(variables, self.enc_cfg, self.dec_cfg, self.loss_cfg)
        self.model.load_state_dict(sd, strict=True)
