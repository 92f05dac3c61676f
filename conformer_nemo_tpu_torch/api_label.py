"""Label-task models: speech classification and VAD, regression, and speaker
recognition (port of conformer_nemo_tpu/api_label.py).

    model = ClassificationModel(labels=["no", "yes"])          # MatchboxNet, CUDA
    model.fit("train.json", "val.json", max_steps=1000)
    model.predict(["a.wav"])                                    # label strings
    probs = model.vad_frame_probs(wav)                          # P(speech) every 10 ms
    spk = SpeakerLabelModel(labels=speakers)                    # ECAPA + angular loss
    spk.verify_speakers("a.wav", "b.wav")

- `ClassificationModel`: a ConvASREncoder (MatchboxNet 3x1x64 by default)
  and a pooled linear head, cross entropy, top-k accuracy, `predict`,
  sliding-window VAD probabilities (`vad_frame_probs`, `as_vad_callable`),
  `change_labels` (a new head, the encoder kept), and
  `change_se_context_window`.
- `RegressionModel`: the same with one output, MSE loss, MSE/MAE evaluation.
- `SpeakerLabelModel`: ECAPA (filters 512 x 4 + 1536), attentive pooling,
  a 192-wide embedding, the angular (ArcFace) loss; `get_embedding`,
  `verify_speakers`, `get_batch_embeddings`.

Training follows the JAX `fit`: batches of fixed length (shorter signals
repeated, data/audio_to_label.py), log-mel features in training mode, the
optional SpecAugment, adamw at a constant rate with optax's defaults; each
`fit` starts a new optimizer state. The train state's CPU generator draws
each step's seeds (features, augmentation, the encoder's draws: dropout,
the SE context start, the tower weights).

These models compute in fp32, as the JAX models' dtype says: cuDNN's TF32
is switched off around their forwards and backwards
(models/conv_asr.py `fp32_convolutions`), so the card agrees with the CPU
to fp32 rounding. Archives are the JAX package's `.cntpu` (`kind`
classification | regression | speaker, the architecture under `arch`),
through convert/jax_params.py `label_variables_to_jax` /
`label_state_dict_from_jax`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from conformer_nemo_tpu_torch.api import init_weights
from conformer_nemo_tpu_torch.audio.features import MelFeatureConfig, log_mel_spectrogram
from conformer_nemo_tpu_torch.audio.spec_augment import (
    SpecAugmentConfig,
    apply_spectrogram_augmentation,
)
from conformer_nemo_tpu_torch.convert.jax_params import (
    label_state_dict_from_jax,
    label_variables_to_jax,
)
from conformer_nemo_tpu_torch.data.audio_io import load_audio
from conformer_nemo_tpu_torch.data.audio_to_label import (
    AudioToLabelDataset,
    FixedSeqLabelLoader,
    repeat_to_length,
)
from conformer_nemo_tpu_torch.device import resolve_device
from conformer_nemo_tpu_torch.models.classification import (
    ClassificationDecoder,
    ClassificationDecoderConfig,
)
from conformer_nemo_tpu_torch.models.conv_asr import (
    ConvASREncoder,
    ConvASREncoderConfig,
    JasperBlockConfig,
    change_se_context_window,
    fp32_convolutions,
)
from conformer_nemo_tpu_torch.models.tdnn import (
    ECAPAEncoder,
    ECAPAEncoderConfig,
    SpeakerDecoder,
    SpeakerDecoderConfig,
)
from conformer_nemo_tpu_torch.ops.classification_losses import (
    angular_softmax_loss,
    cross_entropy_loss,
    mse_loss,
    top_k_counts,
)
from conformer_nemo_tpu_torch.train.checkpoint import load_portable, save_portable
from conformer_nemo_tpu_torch.train.optim import apply_updates, constant_adamw
from conformer_nemo_tpu_torch.train.trainer import TrainState, _seeded, run_epochs


def matchboxnet_blocks(num_blocks: int = 3, repeat: int = 1, width: int = 64):
    """MatchboxNet-3x1x64-style topology: prologue conv, B sub-blocks, a
    dilated epilogue, a 1x1 head."""
    blocks = [JasperBlockConfig(filters=128, repeat=1, kernel=11, stride=1, residual=False,
                                separable=True)]
    for i in range(num_blocks):
        blocks.append(JasperBlockConfig(filters=width, repeat=repeat, kernel=13 + 2 * i,
                                        residual=True, separable=True, dropout=0.0))
    blocks.append(JasperBlockConfig(filters=128, repeat=1, kernel=29, dilation=2,
                                    residual=False, separable=True))
    blocks.append(JasperBlockConfig(filters=128, repeat=1, kernel=1, residual=False))
    return blocks


class ClassificationNet(nn.Module):
    def __init__(self, enc_cfg: ConvASREncoderConfig, dec_cfg: ClassificationDecoderConfig):
        super().__init__()
        self.encoder = ConvASREncoder(enc_cfg)
        self.decoder = ClassificationDecoder(dec_cfg)

    def forward(self, feats, lengths, generator=None):
        x, lens = self.encoder(feats, lengths, generator)
        return self.decoder(x, lens)


class SpeakerNet(nn.Module):
    def __init__(self, enc_cfg: ECAPAEncoderConfig, dec_cfg: SpeakerDecoderConfig):
        super().__init__()
        self.encoder = ECAPAEncoder(enc_cfg)
        self.decoder = SpeakerDecoder(dec_cfg)

    def forward(self, feats, lengths, generator=None):
        h, lens = self.encoder(feats, lengths)
        return self.decoder(h, lens)


def _as_list(v):
    return list(v) if isinstance(v, tuple) else v


class _EncDecLabelModel:
    """What the three label models share: construction on a device, fit,
    evaluate, inference and the portable archive. A subclass builds its
    module in `_build_net` and gives `_loss`, `_logits` and `_step_metric`."""

    kind = "label"
    metric_name = "acc"

    def __init__(self, labels: Sequence[str], sample_rate: int = 16000,
                 mel: Optional[MelFeatureConfig] = None,
                 spec_augment: Optional[SpecAugmentConfig] = None, device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.labels = list(labels)
        self.sample_rate = sample_rate
        self.mel = mel or MelFeatureConfig(features=64)
        self.spec_augment = spec_augment or SpecAugmentConfig()
        self.seed = seed
        self.train_state: Optional[TrainState] = None
        self.model = self._new_net()

    def _new_net(self) -> nn.Module:
        """The module, drawn with the JAX package's initialisers from the seed."""
        net = self._build_net()
        gen = torch.Generator().manual_seed(self.seed)
        init_weights(net, gen)
        if isinstance(net, SpeakerNet):
            net.decoder.reset_final(gen)
        return net.to(self.device).eval()

    def _build_net(self) -> nn.Module:
        raise NotImplementedError

    def _loss(self, out, labels):
        raise NotImplementedError

    def _logits(self, out):
        return out

    def _step_metric(self, logits, labels):
        """The training step's metric: top-1 accuracy."""
        correct, total = top_k_counts(logits, labels, (1,))
        return correct[0] / torch.clamp(total[0], min=1)

    def _make_dataset(self, manifest: str) -> AudioToLabelDataset:
        return AudioToLabelDataset(manifest, self.labels, sample_rate=self.sample_rate)

    # -- the forward ----------------------------------------------------------

    def _features(self, audio, lens, generator=None, training: bool = False) -> tuple:
        return log_mel_spectrogram(self.mel, torch.as_tensor(audio).to(self.device),
                                   torch.as_tensor(lens).to(self.device), generator=generator,
                                   training=training)

    def _infer(self, audio, lens):
        """Eval-mode output of the model on a waveform batch (no gradient)."""
        self.model.eval()
        with torch.no_grad(), fp32_convolutions():
            feats, flens = self._features(audio, lens)
            return self.model(feats, flens)

    def _infer_logits(self, audio, lens) -> torch.Tensor:
        return self._logits(self._infer(audio, lens))

    # -- training -----------------------------------------------------------

    def make_train_step(self, optimizer, augment: bool = False):
        """-> step(audio, lens, labels) -> {"loss", metric}, updating the
        train state in place."""
        spec_aug = self.spec_augment if augment and self.spec_augment.enabled else None

        def step_fn(audio, lens, labels) -> dict:
            state = self.train_state
            dev = self.device
            labels = torch.as_tensor(labels).to(dev)
            feat_s, aug_s, drop_s = (
                int(s) for s in torch.randint(0, 1 << 62, (3,), generator=state.generator))
            self.model.train()
            with fp32_convolutions():
                with torch.no_grad():
                    feats, flens = self._features(audio, lens, _seeded(dev, feat_s), True)
                    if spec_aug is not None:
                        feats = apply_spectrogram_augmentation(spec_aug, _seeded(dev, aug_s),
                                                               feats, flens)
                out = self.model(feats, flens, _seeded(dev, drop_s))
                loss = self._loss(out, labels)
                params = state.params
                grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            updates, state.opt_state = optimizer.update(grads, state.opt_state, params)
            apply_updates(params, updates)
            state.step += 1
            return {"loss": loss.detach(),
                    self.metric_name: self._step_metric(self._logits(out).detach(), labels)}

        return step_fn

    def fit(self, train_manifest: str, val_manifest: Optional[str] = None,
            max_steps: int = 100, max_epochs: int = 1000000, batch_size: int = 32,
            fixed_seconds: float = 4.0, lr: float = 1e-3, weight_decay: float = 1e-4,
            augment: bool = False, log_every_n_steps: int = 20) -> dict:
        """-> {"steps", "time_s", "history": [{"step", "loss", metric}],
        and "val" with a validation manifest}; eval mode on return."""
        ds = self._make_dataset(train_manifest)
        loader = FixedSeqLabelLoader(ds, batch_size, fixed_seconds, shuffle=True,
                                     drop_last=False)
        optimizer = constant_adamw(lr, weight_decay)
        params = list(self.model.parameters())
        if self.train_state is None:
            self.train_state = TrainState(model=self.model, opt_state=optimizer.init(params),
                                          generator=torch.Generator().manual_seed(self.seed + 1))
        else:
            self.train_state.opt_state = optimizer.init(params)
        step_fn = self.make_train_step(optimizer, augment)
        t0, history = time.time(), []

        def log_step(step: int, metrics: dict) -> None:
            if step % log_every_n_steps == 0 or step >= max_steps:
                history.append({"step": step, "loss": float(metrics["loss"]),
                                self.metric_name: float(metrics[self.metric_name])})

        # a loader batch is (audio, lens, labels, rows before padding)
        run_epochs(self.train_state, lambda b: step_fn(*b[:3]),
                   lambda: contextlib.nullcontext(loader), max_epochs, max_steps, log_step)
        result = {"steps": self.train_state.step, "time_s": time.time() - t0,
                  "history": history}
        if val_manifest:
            result["val"] = self.evaluate(val_manifest, batch_size, fixed_seconds)
        return result

    def evaluate(self, manifest: str, batch_size: int = 32, fixed_seconds: float = 4.0,
                 top_k: Sequence[int] = (1,)) -> dict:
        """Top-k accuracy over a manifest: correct and total counts summed
        over its batches."""
        loader = FixedSeqLabelLoader(self._make_dataset(manifest), batch_size, fixed_seconds)
        correct = np.zeros(len(top_k), np.int64)
        total = np.zeros(len(top_k), np.int64)
        for audio, lens, labels, n in loader:
            logits = self._infer_logits(audio, lens)
            c, t = top_k_counts(logits[:n], torch.as_tensor(labels[:n]).to(logits.device),
                                tuple(top_k))
            correct += c.cpu().numpy()
            total += t.cpu().numpy()
        return {f"top{k}": float(c) / max(int(t), 1) for k, c, t in zip(top_k, correct, total)}

    def _fixed_batches(self, audio_paths: Sequence[str], batch_size: int, fixed_seconds: float):
        """(audio [n, T], lens [n]) batches of files repeated or cut to
        fixed_seconds, as `predict` feeds them."""
        t_fixed = int(fixed_seconds * self.sample_rate)
        for i in range(0, len(audio_paths), batch_size):
            chunk = audio_paths[i: i + batch_size]
            audio = np.zeros((len(chunk), t_fixed), np.float32)
            for row, p in enumerate(chunk):
                audio[row] = repeat_to_length(load_audio(p, target_sr=self.sample_rate), t_fixed)
            yield audio, np.full((len(chunk),), t_fixed, np.int32)

    # -- persistence ----------------------------------------------------------

    def _arch_dict(self) -> dict:
        """The architecture's constructor arguments, so that a restore
        rebuilds the topology without the caller passing them."""
        return {}

    def _config_dict(self) -> dict:
        return {"model": {"kind": self.kind, "labels": self.labels,
                          "sample_rate": self.sample_rate,
                          "preprocessor": dataclasses.asdict(self.mel),
                          "arch": self._arch_dict()}}

    @property
    def portable_variables(self) -> dict:
        """The JAX model's `{"params", "batch_stats"}` (numpy)."""
        return label_variables_to_jax(self.model.state_dict(), self.model)

    def save_portable(self, path: str) -> None:
        save_portable(path, self._config_dict(), self.portable_variables)

    @classmethod
    def restore_portable(cls, path: str, device=None, seed: int = 0, **kwargs):
        """A `.cntpu` of this kind written by either package -> a model on
        `device` (None: CUDA)."""
        resolve_device(device)  # fail before any work when CUDA is missing
        config, variables, _ = load_portable(path)
        m = config["model"]
        if m.get("kind") != cls.kind:
            raise ValueError(f"{path} holds a {m.get('kind')!r} model, not {cls.kind!r}")
        if "mel" not in kwargs and m.get("preprocessor"):
            kwargs["mel"] = MelFeatureConfig(**m["preprocessor"])
        for key, val in (m.get("arch") or {}).items():
            kwargs.setdefault(key, val)
        model = cls(labels=m["labels"], sample_rate=m["sample_rate"], device=device, seed=seed,
                    **kwargs)
        model.model.load_state_dict(label_state_dict_from_jax(variables, model.model))
        return model


class ClassificationModel(_EncDecLabelModel):
    """Speech-command / VAD classification."""

    kind = "classification"

    def __init__(self, labels, sample_rate=16000, mel=None, spec_augment=None, blocks=None,
                 pooling_type: str = "avg", dtype=torch.float32, device=None, seed: int = 0):
        def _mk(b):
            if isinstance(b, JasperBlockConfig):
                return b
            b = dict(b)
            if isinstance(b.get("kernel"), list):  # an archived parallel block's kernels
                b["kernel"] = tuple(b["kernel"])
            return JasperBlockConfig(**b)

        self._blocks = [_mk(b) for b in (blocks or matchboxnet_blocks())]
        self._pooling = pooling_type
        self._dtype = dtype
        super().__init__(labels, sample_rate, mel, spec_augment, device=device, seed=seed)

    def _num_outputs(self) -> int:
        return len(self.labels)

    def _build_net(self):
        enc = ConvASREncoderConfig(feat_in=self.mel.features, blocks=tuple(self._blocks),
                                   dtype=self._dtype)
        dec = ClassificationDecoderConfig(feat_in=self._blocks[-1].filters,
                                          num_classes=self._num_outputs(),
                                          pooling_type=self._pooling, dtype=self._dtype)
        return ClassificationNet(enc, dec)

    def _arch_dict(self):
        return {"blocks": [{k: _as_list(v) for k, v in dataclasses.asdict(b).items()}
                           for b in self._blocks],
                "pooling_type": self._pooling}

    def _loss(self, out, labels):
        return cross_entropy_loss(out, labels)

    def predict(self, audio_paths: Sequence[str], batch_size: int = 32,
                fixed_seconds: float = 4.0, logprobs: bool = False) -> list:
        """Label strings (or log-probability rows) of files repeated or cut
        to fixed_seconds."""
        outs: List[Any] = []
        for audio, lens in self._fixed_batches(audio_paths, batch_size, fixed_seconds):
            logits = self._infer_logits(audio, lens)
            if logprobs:
                outs.extend(torch.log_softmax(logits, -1).cpu().numpy())
            else:
                outs.extend(self.labels[j] for j in logits.argmax(-1).cpu().numpy())
        return outs

    def vad_frame_probs(self, wav: np.ndarray, window_length_in_sec: float = 0.63,
                        shift_length_in_sec: float = 0.01, speech_label: str = "speech",
                        batch_size: int = 256) -> np.ndarray:
        """P(speech) of a window starting every shift_length_in_sec over the
        waveform (the last label when none is `speech_label`), batch_size
        windows a forward. Post-process with
        decode/vad.py `postprocess_frame_predictions`."""
        try:
            speech_idx = self.labels.index(speech_label)
        except ValueError:
            speech_idx = len(self.labels) - 1
        win = int(window_length_in_sec * self.sample_rate)
        shift = int(shift_length_in_sec * self.sample_rate)
        wav = np.asarray(wav, np.float32)
        if len(wav) < win:
            wav = np.pad(wav, (0, win - len(wav)))
        n_frames = (len(wav) - win) // shift + 1
        probs = np.zeros(n_frames, np.float32)
        lens = np.full((batch_size,), win, np.int32)
        for i in range(0, n_frames, batch_size):
            n = min(batch_size, n_frames - i)
            batch = np.zeros((batch_size, win), np.float32)
            for r in range(n):
                s = (i + r) * shift
                batch[r] = wav[s: s + win]
            p = torch.softmax(self._infer_logits(batch, lens), -1)[:, speech_idx]
            probs[i: i + n] = p[:n].cpu().numpy()
        return probs

    def as_vad_callable(self, params: Optional[dict] = None,
                        window_length_in_sec: float = 0.63, shift_length_in_sec: float = 0.01):
        """A `(wav, sr) -> [(start, end), ...]` function: this model's frame
        probabilities through the VAD post-processing chain."""
        from conformer_nemo_tpu_torch.decode.vad import postprocess_frame_predictions

        def _vad(wav, sr):
            if sr != self.sample_rate:
                raise ValueError(f"expected {self.sample_rate} Hz audio, got {sr}")
            probs = self.vad_frame_probs(wav, window_length_in_sec, shift_length_in_sec)
            return postprocess_frame_predictions(probs, params,
                                                 shift_length_in_sec=shift_length_in_sec)

        return _vad

    def change_se_context_window(self, context_window: int) -> None:
        """Swap every SE's pooling context (streaming); the parameters stay."""
        self._blocks = change_se_context_window(self._blocks, context_window)
        state = self.model.state_dict()
        self.model = self._build_net().to(self.device).eval()
        self.model.load_state_dict(state)
        if self.train_state is not None:
            self.train_state.model = self.model

    def change_labels(self, new_labels: Sequence[str]) -> None:
        """A new head for a new label set, drawn from the model's seed; the
        encoder and its statistics stay. The optimizer state goes."""
        encoder = self.model.encoder.state_dict()
        self.labels = list(new_labels)
        self.model = self._new_net()
        self.model.encoder.load_state_dict(encoder)
        self.train_state = None


class RegressionModel(ClassificationModel):
    """Speech regression: the classification network with one output, MSE
    loss, MSE/MAE evaluation, `predict` -> floats."""

    kind = "regression"
    metric_name = "mse"

    def __init__(self, labels=(), sample_rate=16000, mel=None, spec_augment=None, blocks=None,
                 pooling_type: str = "avg", dtype=torch.float32, device=None, seed: int = 0):
        super().__init__(list(labels), sample_rate, mel, spec_augment, blocks=blocks,
                         pooling_type=pooling_type, dtype=dtype, device=device, seed=seed)

    def _num_outputs(self) -> int:
        return 1

    def _make_dataset(self, manifest: str) -> AudioToLabelDataset:
        return AudioToLabelDataset(manifest, sample_rate=self.sample_rate,
                                   is_regression_task=True)

    def _loss(self, out, labels):
        return mse_loss(out.reshape(-1), labels)

    def _logits(self, out):
        return out.reshape(-1)

    def _step_metric(self, preds, targets):
        return mse_loss(preds, targets)

    def evaluate(self, manifest: str, batch_size: int = 32, fixed_seconds: float = 4.0,
                 top_k: Sequence[int] = ()) -> dict:
        """Summed squared and absolute errors over the batches -> MSE, MAE."""
        loader = FixedSeqLabelLoader(self._make_dataset(manifest), batch_size, fixed_seconds)
        se = ae = 0.0
        count = 0
        for audio, lens, targets, n in loader:
            err = self._infer_logits(audio, lens).cpu().numpy()[:n] - targets[:n]
            se += float(np.sum(err ** 2))
            ae += float(np.sum(np.abs(err)))
            count += n
        return {"mse": se / max(count, 1), "mae": ae / max(count, 1)}

    def predict(self, audio_paths: Sequence[str], batch_size: int = 32,
                fixed_seconds: float = 4.0, logprobs: bool = False) -> list:
        """Predicted values as floats."""
        return [float(v) for audio, lens in self._fixed_batches(audio_paths, batch_size,
                                                                fixed_seconds)
                for v in self._infer_logits(audio, lens).cpu().numpy()]


class SpeakerLabelModel(_EncDecLabelModel):
    """Speaker recognition and verification."""

    kind = "speaker"

    def __init__(self, labels, sample_rate=16000, mel=None, spec_augment=None,
                 filters=(512, 512, 512, 512, 1536), kernel_sizes=(5, 3, 3, 3, 1),
                 dilations=(1, 2, 3, 4, 1), scale=8, emb_sizes=(192,), pool_mode="attention",
                 angular=True, loss_scale=30.0, loss_margin=0.2, dtype=torch.float32,
                 device=None, seed: int = 0):
        self._ecapa = dict(filters=tuple(filters), kernel_sizes=tuple(kernel_sizes),
                           dilations=tuple(dilations), scale=scale)
        self._dec = dict(emb_sizes=tuple(emb_sizes), pool_mode=pool_mode, angular=angular)
        self.angular = angular
        self.loss_scale = loss_scale
        self.loss_margin = loss_margin
        self._dtype = dtype
        super().__init__(labels, sample_rate, mel, spec_augment, device=device, seed=seed)

    def _arch_dict(self):
        return {**{k: _as_list(v) for k, v in self._ecapa.items()},
                "emb_sizes": list(self._dec["emb_sizes"]), "pool_mode": self._dec["pool_mode"],
                "angular": self.angular, "loss_scale": self.loss_scale,
                "loss_margin": self.loss_margin}

    def _build_net(self):
        enc = ECAPAEncoderConfig(feat_in=self.mel.features, dtype=self._dtype, **self._ecapa)
        dec = SpeakerDecoderConfig(feat_in=self._ecapa["filters"][-1],
                                   num_classes=len(self.labels), dtype=self._dtype, **self._dec)
        return SpeakerNet(enc, dec)

    def _loss(self, out, labels):
        logits, _emb = out
        if self.angular:
            return angular_softmax_loss(logits, labels, self.loss_scale, self.loss_margin)
        return cross_entropy_loss(logits, labels)

    def _logits(self, out):
        return out[0]

    def get_embedding(self, audio_path: str) -> np.ndarray:
        """The speaker embedding of one file, at its own length."""
        wav = load_audio(audio_path, target_sr=self.sample_rate)
        _logits, emb = self._infer(wav[None, :], np.array([len(wav)], np.int32))
        return emb[0].cpu().numpy()

    def verify_speakers(self, path1: str, path2: str, threshold: float = 0.7) -> bool:
        """(cos + 1) / 2 of the two embeddings >= threshold."""
        e1, e2 = self.get_embedding(path1), self.get_embedding(path2)
        e1 = e1 / np.linalg.norm(e1)
        e2 = e2 / np.linalg.norm(e2)
        return (float(e1 @ e2) + 1.0) / 2.0 >= threshold

    def get_batch_embeddings(self, manifest: str, batch_size: int = 32,
                             fixed_seconds: float = 4.0) -> tuple:
        """-> (embeddings, logits, labels, id2label) of a manifest."""
        ds = AudioToLabelDataset(manifest, self.labels, sample_rate=self.sample_rate)
        embs, logits_all, labels_all = [], [], []
        for audio, lens, labels, n in FixedSeqLabelLoader(ds, batch_size, fixed_seconds):
            logits, emb = self._infer(audio, lens)
            embs.append(emb[:n].cpu().numpy())
            logits_all.append(logits[:n].cpu().numpy())
            labels_all.append(labels[:n])
        return (np.concatenate(embs), np.concatenate(logits_all), np.concatenate(labels_all),
                ds.id2label)
