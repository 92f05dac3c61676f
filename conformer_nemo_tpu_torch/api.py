"""User API: build a Conformer-CTC or Conformer-Transducer model, train it
and transcribe (port of the `ConformerCTC` / `ConformerTransducer` surface
of conformer_nemo_tpu/api.py, with their shared `_BaseASRModel`).

    model = ConformerCTC.from_config_file("configs/conformer_ctc_bpe.yaml",
                                          overrides={...})   # runs on CUDA
    model.load_state_dict(state_dict)   # NeMo names; see convert/jax_params.py
    model.fit("train.json", "val.json", max_steps=1000)
    texts = model.transcribe(["a.wav", "b.wav"])

`ConformerTransducer` takes the same calls. Decoding follows the JAX
package: `change_decoding_strategy` takes greedy or beamsearch_ngram (CTC
prefix beam search with an n-gram LM: ARPA, its `.binlm` cache, or a
probing/trie KenLM `.bin`, through the native decoder built from
data/csrc/ctc_beam.cpp) for CTC, and greedy, greedy_batch, beam, tsd,
alsd, maes or beam_batch for the transducer; `transcribe_with_timestamps`
gives word timestamps from greedy alignments for both.

Training runs survive a restart: `fit(exp_manager=...)` logs, checkpoints
at each validation (train/checkpoint.py, the write on a background thread)
and resumes from the last checkpoint (`resume_if_exists`), as does
`trainer.resume_from_checkpoint`. `save_portable` / `restore_portable` write
and read the JAX package's `.cntpu` archive, so either package serves the
other's models; `from_pretrained` resolves a registered name in the local
archive cache (pretrained.py).

Batching follows the JAX package: files up to `longform_threshold_s` are
sorted by length and decoded `batch_size` at a time, padded to a multiple
of 1600 samples and to `batch_size` rows with zero rows; each longer file
takes an exact whole-utterance forward alone, padded to threshold * 2^k.

`fit` trains with the config's optimizer, schedule, loader and validation
cadence. The loader reads WAV, FLAC, MP3 and Ogg (Vorbis/Opus) from a
manifest or from tar shards, in the config's wire format (`transport`:
f32 | pcm16 | mulaw8), trimmed and augmented where the config asks;
`device_prefetch` copies its batches to the device ahead of the step.

Under a launcher (`torchrun --nproc-per-node N`, one process per GPU,
parallel/distributed.py `initialize_distributed` called first, as the
training scripts do) `fit` trains on every rank over `trainer.mesh`
(parallel/mesh.py: `data: -1` takes world // model ranks): data
parallelism with a synchronised BatchNorm over the data axis, the
tensor-parallel encoder over the model axis (parallel/sharding.py). Each
rank loads `batch_size` rows of its own, so the global batch is
batch_size x data. Outside a launcher it trains on the model's one device
and logs that.

Both families also decode long audio in buffers (`transcribe_buffered`:
chunks of `frame_len` seconds in buffers of `total_buffer`, decode/streaming.py,
the CTC middle-token merge or the transducer's LCS merge), swap their
vocabulary for fine-tuning (`change_vocabulary`: a new head, the encoder
kept), and export their inference functions through `torch.export`
(`export`, read back by utils/export.py `load_exported`). A NeMo `.nemo`
archive becomes a `.cntpu` through scripts/convert_nemo.py.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import os
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from conformer_nemo_tpu_torch.audio.features import log_mel_spectrogram, mel_seq_len
from conformer_nemo_tpu_torch.audio.perturb import process_augmentations
from conformer_nemo_tpu_torch.config.loader import (
    build_ctc_model_config,
    build_rnnt_model_config,
    load_config,
)
from conformer_nemo_tpu_torch.convert.jax_params import (
    ctc_state_dict_from_jax,
    ctc_variables_to_jax,
    rnnt_state_dict_from_jax,
    rnnt_variables_to_jax,
)
from conformer_nemo_tpu_torch.data.audio_io import load_audio
from conformer_nemo_tpu_torch.data.dataset import BucketedAudioTextDataset, BucketedLoader
from conformer_nemo_tpu_torch.data.manifest import read_manifest
from conformer_nemo_tpu_torch.data.tarred import TarredAudioTextDataset, TarredBatchIterator
from conformer_nemo_tpu_torch.data.hf_tokenizer import HFJsonTokenizer
from conformer_nemo_tpu_torch.data.prefetch import device_prefetch
from conformer_nemo_tpu_torch.data.tokenizers import build_tokenizer
from conformer_nemo_tpu_torch.decode.ctc_beam import BeamSearchDecoderWithLM
from conformer_nemo_tpu_torch.decode.ctc_greedy import collapse_ctc_ids, ctc_greedy_decode
from conformer_nemo_tpu_torch.decode.rnnt_decoding import RNNTDecoding
from conformer_nemo_tpu_torch.decode.rnnt_greedy import rnnt_greedy_decode_batched
from conformer_nemo_tpu_torch.decode.streaming import BatchedFrameASRRNNT, FrameBatchASR
from conformer_nemo_tpu_torch.decode.timestamps import (
    FrameAlignedToken,
    WordTimestamp,
    ctc_frame_alignments,
    words_from_alignments,
)
from conformer_nemo_tpu_torch.device import resolve_device
from conformer_nemo_tpu_torch.models.conformer import (
    check_flash_dtype,
    check_flash_training,
    encoder_lengths,
    frame_factor,
)
from conformer_nemo_tpu_torch.models.ctc_model import CTCModel, ctc_forward
from conformer_nemo_tpu_torch.models.rnnt import PredictionNetwork, RNNTModel, check_joint
from conformer_nemo_tpu_torch.parallel.distributed import all_reduce_min, is_main_process
from conformer_nemo_tpu_torch.parallel.mesh import Mesh, make_mesh, parse_mesh
from conformer_nemo_tpu_torch.parallel.sharding import full_state_dict
from conformer_nemo_tpu_torch.train.checkpoint import (
    load_portable,
    restore_train_state,
    save_portable,
)
from conformer_nemo_tpu_torch.train.exp_manager import ExperimentManager
from conformer_nemo_tpu_torch.train.lr_schedule import make_lr_schedule
from conformer_nemo_tpu_torch.train.optim import make_optimizer, with_grad_accumulation
from conformer_nemo_tpu_torch.train.rnnt_trainer import (
    evaluate_rnnt_wer,
    init_rnnt_state,
    make_rnnt_eval_step,
    make_rnnt_loss_eval_step,
    make_rnnt_train_step,
)
from conformer_nemo_tpu_torch.train.trainer import (
    distribute_state,
    evaluate_wer,
    init_ctc_state,
    make_ctc_train_step,
    run_epochs,
    undistribute_state,
)
from conformer_nemo_tpu_torch.utils.export import export_fn, save_exported

log = logging.getLogger(__name__)


@dataclasses.dataclass
class TranscriptionHypothesis:
    """Decode result: score, token ids, text and, from the transducer's
    greedy decode, each token's emission frame."""

    score: float
    y_sequence: List[int]
    text: str
    timestep: Optional[List[int]] = None


def _char_parser(m: dict) -> str:
    """The char tokenizer's parser: the training set's `parser`, as the JAX
    package builds it."""
    return (m.get("train_ds") or {}).get("parser") or "base"


def _tokenizer_from_model_cfg(m: dict, tokenizer_dir: Optional[str] = None):
    if m.get("labels"):
        return build_tokenizer({"labels": m["labels"]}, parser=_char_parser(m))
    tok_cfg = dict(m.get("tokenizer") or {})
    if tokenizer_dir:
        tok_cfg["dir"] = tokenizer_dir
    return build_tokenizer(tok_cfg)


def _tokenizer_from_archive(m: dict, artifacts: dict):
    """The JAX package's restore rules: `labels` (with the training set's
    parser); an HF `tokenizer` artifact; or the config's tokenizer over the
    archive's files. An aggregate tokenizer's per-language `model_file`
    entries are base names of files stored flat in the archive. A set
    `model_file` is read where it points, as the JAX package reads it, or,
    where that path is gone (an archive from another machine), from the
    archive's file of the same base name."""
    if m.get("labels"):
        return build_tokenizer({"labels": m["labels"]}, parser=_char_parser(m))
    if "tokenizer" in artifacts:
        return HFJsonTokenizer(artifacts["tokenizer"])
    if artifacts and m.get("tokenizer"):
        tcfg = {k: v for k, v in m["tokenizer"].items() if k != "dir"}
        tdir = os.path.dirname(next(iter(artifacts.values())))
        if tcfg.get("type") == "agg":
            langs = {}
            for lang, sub in (tcfg.get("langs") or {}).items():
                sub = {k: v for k, v in sub.items() if k != "dir"}
                if not sub.get("model_file"):
                    # the files are stored flat: a shared dir would load one
                    # language's model for every language
                    raise ValueError(f"aggregate tokenizer config for lang {lang!r} has no "
                                     "model_file entry")
                if not os.path.isabs(sub["model_file"]):
                    sub["model_file"] = os.path.join(tdir, sub["model_file"])
                langs[lang] = sub
            return build_tokenizer({**tcfg, "langs": langs})
        mf = tcfg.get("model_file")
        if mf and not os.path.isfile(mf):
            tcfg["model_file"] = os.path.join(tdir, os.path.basename(mf))
        return build_tokenizer({**tcfg, "dir": tdir})
    raise ValueError("no tokenizer artifact in portable archive")


def _pad_batch(wavs: list, rows: int) -> tuple:
    """Waveforms -> (audio [rows, t_cap] f32, lens [rows] int32): padded to
    a multiple of 1600 samples, zero rows past the waveforms."""
    t_cap = int(math.ceil(max(len(w) for w in wavs) / 1600.0)) * 1600
    audio = np.zeros((rows, t_cap), np.float32)
    lens = np.zeros((rows,), np.int32)
    for row, w in enumerate(wavs):
        audio[row, : len(w)] = w
        lens[row] = len(w)
    return audio, lens


def _while_every_rank_has_one(batches, mesh: Mesh):
    """The batches of a stream of unknown length (tar shards), while every
    rank has one: the ranks agree step by step (one all-reduce on the host,
    here in the consumer's thread and not in the prefetch's)."""
    if not mesh.distributed:
        yield from batches
        return
    it = iter(batches)
    while True:
        batch = next(it, None)
        if all_reduce_min(int(batch is not None)) == 0:
            if batch is not None:
                log.info("fit: rank %d ends its stream early: another rank's has ended",
                         mesh.rank)
            return
        yield batch


def _any_rank(flag: bool, mesh: Mesh) -> bool:
    """Whether the flag is set on any rank (so that every rank stops together)."""
    return all_reduce_min(int(not flag)) == 0 if mesh.distributed else flag


class _CTCForward(nn.Module):
    """The exported CTC function: audio [B, T] f32, lens [B] int32 ->
    (log_probs [B, T', V+1], enc_lens [B]), the frontend in eval mode."""

    def __init__(self, model: CTCModel):
        super().__init__()
        self.model = model

    def forward(self, audio, lens):
        feats, feat_lens = log_mel_spectrogram(self.model.cfg.preprocessor, audio, lens)
        return self.model(feats, feat_lens)


class _Encoder(nn.Module):
    """The exported transducer encoder: audio [B, T] f32, lens [B] int32 ->
    (enc [B, T', D] f32, enc_lens [B])."""

    def __init__(self, encoder: nn.Module, preprocessor):
        super().__init__()
        self.encoder = encoder
        self.preprocessor = preprocessor

    def forward(self, audio, lens):
        feats, feat_lens = log_mel_spectrogram(self.preprocessor, audio, lens)
        enc, enc_lens = self.encoder(feats, feat_lens)
        return enc.transpose(1, 2), enc_lens


class _DecoderJoint(nn.Module):
    """The exported decode step: (enc_t [B, D] f32, last_label [B] int32,
    h, c [L, B, H] f32) -> (logits [B, V+1], h, c): one prediction-network
    step from (h, c) on the last label, and the joint."""

    def __init__(self, decoder: PredictionNetwork, joint: nn.Module):
        super().__init__()
        self.decoder = decoder
        self.joint = joint

    def forward(self, enc_t, last_label, h, c):
        g, (h, c) = self.decoder.step(last_label, (h, c))
        return self.joint(enc_t, g), h, c


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation with the JAX package's rules: LeCun-normal
    (truncated at two standard deviations) linear and convolution weights
    (the joint's output projection included) and zero biases; the prediction
    network's embedding, xavier-uniform input and orthogonal recurrent LSTM
    weights and its biases (`PredictionNetwork.reset_parameters`). Norms,
    BatchNorm statistics and the rel-pos biases keep their construction
    values (unit scales, zero shifts, identity stats)."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # truncation correction
            nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, PredictionNetwork):
            mod.reset_parameters(generator)


class _BaseASRModel:
    """What ConformerCTC and ConformerTransducer share: construction on a
    device, the state_dict, the optimizer from the config, the loader, `fit`
    on one device with checkpoints and resume, transcribe's bucketing and
    the portable archive. A subclass builds `self.cfg` and `self.model` in
    `_build` and implements `_init_state`, `_make_train_step`, `_evaluate`,
    `_decode_audio_batch`, `_export_functions` and the weight bridge
    `_to_jax` / `_from_jax`."""

    def __init__(self, raw_cfg: dict, tokenizer, dtype: torch.dtype = torch.bfloat16,
                 device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.raw_cfg = raw_cfg
        self.tokenizer = tokenizer
        self.seed = seed
        model = self._build(dtype)
        init_weights(model, torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval()
        self.train_state = None  # optimizer state and step count, made by fit

    @classmethod
    def from_config_file(cls, path: str, tokenizer_dir: Optional[str] = None,
                         overrides: Optional[dict] = None, dtype: torch.dtype = torch.bfloat16,
                         device=None, seed: int = 0):
        resolve_device(device)  # fail before any work when CUDA is missing
        raw = load_config(path, overrides)
        return cls(raw, _tokenizer_from_model_cfg(raw["model"], tokenizer_dir), dtype=dtype,
                   device=device, seed=seed)

    @classmethod
    def list_available_models(cls):
        from conformer_nemo_tpu_torch.pretrained import list_available_models

        return list_available_models(cls.__name__)

    @classmethod
    def from_pretrained(cls, model_name: str, cache_dir: Optional[str] = None,
                        dtype: torch.dtype = torch.bfloat16, device=None, seed: int = 0):
        """A registered name (or a path) resolved in the local archive cache
        (pretrained.py), restored with `restore_portable`."""
        from conformer_nemo_tpu_torch.pretrained import resolve_pretrained

        resolve_device(device)
        return cls.restore_portable(resolve_pretrained(model_name, cache_dir), dtype=dtype,
                                    device=device, seed=seed)

    @classmethod
    def restore_portable(cls, path: str, dtype: torch.dtype = torch.bfloat16, device=None,
                         seed: int = 0):
        """A `.cntpu` archive written by either package -> a model on
        `device`. The tokenizer follows the JAX package's rules: the
        config's `labels`; else an HF `tokenizer` artifact (not ported yet);
        else the config's tokenizer over the archive's files. The weights are
        the archive's, BatchNorm statistics included (a params-only archive
        keeps the construction values); `seed` draws only the construction
        weights that the archive then replaces."""
        resolve_device(device)  # fail before any work when CUDA is missing
        with tempfile.TemporaryDirectory(prefix="cntpu_") as tmp:
            config, restored, artifacts = load_portable(path, extract_dir=tmp)
            model = cls(config, _tokenizer_from_archive(config["model"], artifacts),
                        dtype=dtype, device=device, seed=seed)
        variables = (restored if isinstance(restored, dict) and "params" in restored
                     else {"params": restored})  # a legacy params-only archive
        missing, unexpected = model.model.load_state_dict(model._from_jax(variables),
                                                          strict=False)
        stale = [k for k in missing if not k.endswith((".running_mean", ".running_var"))]
        if stale or unexpected:
            raise ValueError(f"{path}: the archive does not fit the model "
                             f"(missing {stale}, unexpected {unexpected})")
        return model

    @property
    def portable_variables(self) -> dict:
        """The JAX package's `{"params", "batch_stats"}` tree (numpy) of this
        model's weights: what a `.cntpu` archive holds (gathered from the
        ranks of a tensor-parallel model: collective)."""
        return self._to_jax(full_state_dict(self.model))

    def save_portable(self, path: str, artifacts: Optional[dict] = None) -> None:
        """Write the `.cntpu` archive: this model's config, its weights and
        the artifact files ({key: path}); pass a SentencePiece model as
        {"tokenizer_model": path} (not the key "tokenizer", which names an
        HF tokenizer) so that either package can restore the archive.
        Across ranks every rank calls it and rank 0 writes."""
        variables = self.portable_variables
        if is_main_process():
            save_portable(path, self.raw_cfg, variables, artifacts)

    def state_dict(self) -> dict:
        return self.model.state_dict()

    def change_vocabulary(self, tokenizer) -> None:
        """Swap the tokenizer and the head for fine-tuning on a new
        vocabulary (NeMo's change_vocabulary): the head at the new size (the
        CTC decoder; the transducer's prediction network and joint) is drawn
        by `init_weights` from the model's seed, as a model built with this
        seed and tokenizer would have it; the encoder's parameters and
        BatchNorm statistics stay as they are. The optimizer state goes
        (`fit` makes new state), and so do the cached decoders."""
        encoder = self.model.encoder
        self.tokenizer = tokenizer
        model = self._build(self._encoder_config.dtype)
        init_weights(model, torch.Generator().manual_seed(self.seed))
        model.encoder = encoder
        self.model = model.to(self.device).eval()
        self.train_state = None

    def export(self, path: str, batch_size: int = 8, seconds: float = 15.0) -> str:
        """Export the inference functions (`_export_functions`) through
        `torch.export` at batch_size rows of `seconds` of audio, on the
        model's device, into one archive (utils/export.py; read back with
        `load_exported`). Shapes are static: export once per serving
        bucket. -> path."""
        t = int(round(seconds * self.raw_cfg["model"].get("sample_rate", 16000)))
        self.model.eval()
        return save_exported(path, {name: export_fn(fn, args) for name, (fn, args)
                                    in self._export_functions(batch_size, t).items()})

    def _audio_example(self, batch_size: int, t_samples: int) -> tuple:
        return (torch.zeros((batch_size, t_samples), device=self.device),
                torch.full((batch_size,), t_samples, dtype=torch.int32, device=self.device))

    def _buffered_setup(self, frame_len: float, total_buffer: float) -> tuple:
        """Buffered decode's geometry and frontend: (seconds per encoder
        frame, tokens_per_chunk = ceil(frame_len / stride), mid_delay =
        ceil((frame_len + (total_buffer - frame_len) / 2) / stride), and
        feature_fn: samples -> log-mel [D, Tf] in numpy, computed in eval
        mode on the model's device)."""
        pre = self.cfg.preprocessor
        stride = pre.window_stride * frame_factor(self._encoder_config)
        tokens_per_chunk = math.ceil(frame_len / stride)
        mid_delay = math.ceil((frame_len + (total_buffer - frame_len) / 2) / stride)

        def feature_fn(samples: np.ndarray) -> np.ndarray:
            wav = torch.from_numpy(np.asarray(samples, np.float32))[None].to(self.device)
            feats, _ = log_mel_spectrogram(pre, wav, torch.tensor(
                [len(samples)], dtype=torch.int32, device=self.device))
            return feats[0].cpu().numpy()

        return stride, tokens_per_chunk, mid_delay, feature_fn

    def _each_buffered(self, audio_paths: Sequence[str], asr, mid_delay: int, stride: float,
                       transcribe) -> List[str]:
        """Each file through the buffered decoder `asr`, delay-padded."""
        sr = self.raw_cfg["model"].get("sample_rate", 16000)
        out = []
        for p in audio_paths:
            asr.reset()
            asr.read_audio_samples(load_audio(p, target_sr=sr), mid_delay, stride)
            out.append(transcribe(asr))
        return out

    def load_state_dict(self, state_dict: dict) -> None:
        """Load a state_dict with NeMo's names (e.g. from convert.jax_params)."""
        self.model.load_state_dict(state_dict, strict=True)

    # -- training -----------------------------------------------------------

    def _make_optimizer(self, mesh: Optional[Mesh] = None):
        """The config's optimizer; on a tensor-parallel mesh its clipping
        reads the norm of the full gradients and its per-leaf reductions sum
        a sharded leaf's ranks. eps and momentum keep their defaults: the
        JAX package's `_make_optimizer` passes neither."""
        ocfg = self.raw_cfg["model"].get("optim", {"name": "adamw", "lr": 1.0})
        sched_cfg = dict(ocfg.get("sched", {"name": "NoamAnnealing", "d_model": 256,
                                             "warmup_steps": 1000}))
        tr = self.raw_cfg.get("trainer", {})
        tensor_parallel = mesh is not None and mesh.model > 1
        opt = make_optimizer(ocfg.get("name", "adamw"),
                             make_lr_schedule(sched_cfg, ocfg.get("lr", 1.0)),
                             weight_decay=float(ocfg.get("weight_decay", 0.0)),
                             betas=tuple(ocfg.get("betas", (0.9, 0.98))),
                             grad_clip=tr.get("gradient_clip_val") or None,
                             grad_norm=mesh.grad_norm if tensor_parallel else None,
                             model_group=mesh.model_group if tensor_parallel else None)
        return with_grad_accumulation(opt, int(tr.get("accumulate_grad_batches", 1) or 1))

    def _loader(self, manifest: str, ds_cfg: dict, shuffle: bool, mesh: Optional[Mesh] = None):
        """The loader of a manifest (or of tar shards with `is_tarred`). It
        shuffles with seed 0 whatever the model's `seed`, as the JAX
        package's `fit` builds its loaders: the model's seed draws the
        weights and the dropout, not the batch order. The training loader
        (shuffle) alone augments, its augmentor seeded with that seed too.
        On a mesh it reads the slice of the rank's data index (the manifest
        order, or the tar shards, partitioned by rank)."""
        seed = 0
        mesh = mesh or Mesh()
        augmentor = None
        if shuffle and ds_cfg.get("augmentor"):
            augmentor = process_augmentations(ds_cfg["augmentor"], seed=seed)
        sr = ds_cfg.get("sample_rate", 16000)
        if ds_cfg.get("is_tarred"):
            max_dur = float(ds_cfg.get("max_duration") or 20.0)
            ds = TarredAudioTextDataset(
                ds_cfg["tarred_audio_filepaths"], manifest, self.tokenizer, sample_rate=sr,
                shuffle_n=int(ds_cfg.get("shuffle_n", 0)) if shuffle else 0,
                min_duration=ds_cfg.get("min_duration"), max_duration=ds_cfg.get("max_duration"),
                shard_strategy=ds_cfg.get("tarred_shard_strategy", "scatter"),
                world_size=mesh.data, global_rank=mesh.data_index, seed=seed,
                augmentor=augmentor)
            return TarredBatchIterator(ds, ds_cfg.get("batch_size", 16),
                                       max_samples_len=int(max_dur * sr),
                                       max_tokens=max(16, int(max_dur * 8)),
                                       transport=ds_cfg.get("transport"))
        samples = read_manifest(manifest, min_duration=ds_cfg.get("min_duration"),
                                max_duration=ds_cfg.get("max_duration"),
                                max_number=ds_cfg.get("max_utts"))
        ds = BucketedAudioTextDataset(
            samples, self.tokenizer, sample_rate=sr, n_buckets=ds_cfg.get("num_buckets", 8),
            trim_silence=bool(ds_cfg.get("trim_silence", False)),
            use_start_end_token=bool(ds_cfg.get("use_start_end_token", False)),
            augmentor=augmentor)
        return BucketedLoader(
            ds, ds_cfg.get("batch_size", 16), shuffle=shuffle, seed=seed,
            process_index=mesh.data_index, process_count=mesh.data, drop_uneven=shuffle,
            bucketing_strategy=ds_cfg.get("bucketing_strategy", "synced_randomized"),
            num_workers=int(ds_cfg.get("num_workers", 0) or 0),
            transport=ds_cfg.get("transport"))

    def maybe_resume(self, exp_manager: ExperimentManager) -> Optional[dict]:
        """Restore the experiment's last checkpoint into this model's train
        state (made first if there is none) when its config says
        resume_if_exists. -> the checkpoint's meta, or None."""
        if self.train_state is None:
            self.train_state = self._init_state(self._make_optimizer())
        _, meta = exp_manager.maybe_resume(self.train_state)
        return meta

    def fit(self, train_manifest: Optional[str] = None, val_manifest: Optional[str] = None,
            max_steps: Optional[int] = None, max_epochs: Optional[int] = None,
            exp_manager: Optional[ExperimentManager] = None,
            val_every_n_steps: Optional[int] = None, log_every_n_steps: Optional[int] = None,
            max_time_s: Optional[float] = None) -> dict:
        """Train, counting steps from the train state's (a restored
        checkpoint's) step. Validation (greedy WER) runs every
        `val_every_n_steps`, else at the trainer's val_check_interval (an
        int count of steps, or a fraction of an epoch), and at each epoch's
        end; with an experiment manager each validation logs val_wer (and
        val_loss) and checkpoints, and every `log_every_n_steps` (else
        trainer.log_every_n_steps) steps the one host read of the window
        logs train_loss, grad_norm and train_step_timing (the window's wall
        time per step). Past `max_time_s` seconds the run checkpoints and
        stops. `trainer.resume_from_checkpoint` (a checkpoint dir) and the
        experiment manager's resume_if_exists restore before the first step.

        In a process group (parallel/distributed.py) every rank calls fit:
        the mesh comes from trainer.mesh and must fit the world (it raises
        before the first step otherwise); the encoder is sharded over the
        model axis for the run and gathered back at its end; each epoch
        every rank's manifest loader emits the least number of batches any
        rank's plan holds, a rank with more dropping the rest (logged), and
        the ranks of a tarred stream agree at each step whether every one
        still has a batch, so no rank waits in a collective for one that
        has finished. The model is
        in eval mode again on return, with every checkpoint on disk. ->
        {"steps", "time_s", "val", "last_loss", and "stopped": "max_time"
        when the time ran out}."""
        m = self.raw_cfg["model"]
        tr = self.raw_cfg.get("trainer", {})
        mesh = make_mesh(*parse_mesh(tr.get("mesh")))
        log.info("fit: %s", mesh.describe(int(m["train_ds"].get("batch_size", 16))))
        # "???" is the configs' mark of a value left to the caller
        given = lambda v: v if v not in (None, "???") else None
        train_manifest = given(train_manifest) or given(m["train_ds"].get("manifest_filepath"))
        if train_manifest is None:
            raise ValueError("fit needs a training manifest (argument or "
                             "model.train_ds.manifest_filepath)")
        val_manifest = given(val_manifest) or given(
            (m.get("validation_ds") or {}).get("manifest_filepath"))
        max_epochs = max_epochs or tr.get("max_epochs", 1)
        max_steps = max_steps or tr.get("max_steps")
        log_every = log_every_n_steps or tr.get("log_every_n_steps", 10)

        train_loader = self._loader(train_manifest, m.get("train_ds", {}), shuffle=True,
                                    mesh=mesh)
        # the longest batch's frames decide whether "auto" attention takes
        # the flash path; refuse a depth its backward cannot take before a step
        longest = mel_seq_len(self.cfg.preprocessor, torch.tensor(
            [train_loader.max_len if isinstance(train_loader, TarredBatchIterator)
             else train_loader.ds.boundaries[-1]]))
        enc = self._encoder_config
        check_flash_training(enc, self.device, int(encoder_lengths(enc, longest,
                                                                   int(longest[0]))[0]))
        optimizer = self._make_optimizer(mesh)
        if self.train_state is None:
            self.train_state = self._init_state(optimizer)
        rfc = tr.get("resume_from_checkpoint")
        if rfc and restore_train_state(rfc, self.train_state)[0] is None:
            raise FileNotFoundError(f"resume_from_checkpoint: no checkpoint in {rfc}")
        if exp_manager is not None:
            self.maybe_resume(exp_manager)
        distribute_state(self.train_state, mesh)
        step_fn = self._make_train_step(optimizer)
        val_loader = (self._loader(val_manifest, m.get("validation_ds", {}), shuffle=False,
                                   mesh=mesh) if val_manifest else None)
        # a manifest's ranks emit equal counts (BucketedLoader's drop_uneven);
        # a tarred stream's length is unknown, and its ranks agree each step
        epoch_batches = len(train_loader) if isinstance(train_loader, BucketedLoader) else None
        vci = tr.get("val_check_interval")
        if val_every_n_steps is None and isinstance(vci, int) and vci > 0:
            val_every_n_steps = vci
        elif val_every_n_steps is None and isinstance(vci, float) and 0 < vci <= 1:
            if epoch_batches is not None:
                val_every_n_steps = max(1, int(round(vci * epoch_batches)))
            elif vci < 1:  # 1.0 is the end-of-epoch validation, which runs anyway
                raise ValueError("val_check_interval as a fraction of an epoch needs the "
                                 "epoch's length, which a tarred stream does not know: give "
                                 "a number of steps")

        val: dict = {}

        def validate(step: int):
            if val_loader is not None:
                val.update(self._evaluate(val_loader, mesh))
                if exp_manager:
                    exp_manager.logger.log(
                        step, val_wer=val["wer"], **({"val_loss": val["loss"]} if "loss" in val
                                                     else {}))
            if exp_manager:
                exp_manager.save(self.train_state, step, {"val_wer": val.get("wer")})

        t0 = time.time()
        t_window = [t0]

        @contextlib.contextmanager
        def epoch():
            # batches reach the step on the device, copied `depth` ahead
            with contextlib.closing(device_prefetch(train_loader, self.device)) as batches:
                yield (batches if epoch_batches is not None
                       else _while_every_rank_has_one(batches, mesh))

        def after_step(step: int, metrics: dict) -> bool:
            """Log and validate; True stops the run (max_time_s passed)."""
            if exp_manager and step % log_every == 0:
                loss = float(metrics["loss"])  # the window's one host read
                now = time.time()
                exp_manager.logger.log(
                    step, train_loss=loss, grad_norm=float(metrics["grad_norm"]),
                    train_step_timing=(now - t_window[0]) / log_every)
                t_window[0] = now
            if val_every_n_steps and step % val_every_n_steps == 0:
                validate(step)
            if max_steps and step >= max_steps:
                return False  # the loop ends here anyway
            if max_time_s and _any_rank(time.time() - t0 > max_time_s, mesh):
                if exp_manager:
                    exp_manager.save(self.train_state, step, {})
                return True
            return False

        done = False
        try:
            metrics, stopped = run_epochs(self.train_state, step_fn, epoch, max_epochs,
                                          max_steps, after_step, after_epoch=validate)
            done = True
        finally:
            if exp_manager:
                exp_manager.wait_for_saves()
            if done:  # collective: a rank that raised would leave the others waiting
                undistribute_state(self.train_state)
        out = {"steps": self.train_state.step, "time_s": time.time() - t0, "val": dict(val)}
        if metrics:
            out["last_loss"] = float(metrics["loss"])
        if stopped:
            out["stopped"] = "max_time"
        return out

    # -- inference ----------------------------------------------------------

    def transcribe(self, audio_paths: Sequence[str], batch_size: int = 16,
                   logprobs: bool = False, return_hypotheses: bool = False,
                   longform_threshold_s: float = 60.0):
        """Offline transcription of audio files (eval mode, bucket-padded
        batches). `logprobs=True` (CTC only) returns per-file [T, V+1] numpy
        arrays; `return_hypotheses=True` returns TranscriptionHypothesis
        objects."""
        if logprobs and return_hypotheses:
            raise ValueError("logprobs and return_hypotheses are exclusive")
        mode = "logprobs" if logprobs else ("hypotheses" if return_hypotheses else "text")
        sr = self.raw_cfg["model"].get("sample_rate", 16000)
        wavs = [load_audio(p, target_sr=sr) for p in audio_paths]
        long_cut = int(longform_threshold_s * sr)
        short = [j for j, w in enumerate(wavs) if len(w) <= long_cut]
        order = sorted(short, key=lambda j: len(wavs[j]))
        out = [None] * len(wavs)
        for i in range(0, len(order), batch_size):
            idxs = order[i : i + batch_size]
            audio, lens = _pad_batch([wavs[j] for j in idxs], batch_size)
            results = self._decode_audio_batch(audio, lens, mode=mode)[: len(idxs)]
            for j, r in zip(idxs, results):
                out[j] = r
        for j, w in enumerate(wavs):
            if len(w) <= long_cut:
                continue
            t_cap = long_cut
            while t_cap < len(w):
                t_cap *= 2
            audio = np.zeros((1, t_cap), np.float32)
            audio[0, : len(w)] = w
            out[j] = self._decode_audio_batch(audio, np.array([len(w)], np.int32), mode=mode)[0]
        return out


class ConformerCTC(_BaseASRModel):
    def _build(self, dtype: torch.dtype) -> CTCModel:
        self.cfg = build_ctc_model_config(self.raw_cfg, vocab_size=self.tokenizer.vocab_size,
                                          dtype=dtype)
        check_flash_dtype(self.cfg.encoder, self.device)
        self._beam_decoder = None
        return CTCModel(self.cfg)

    def change_decoding_strategy(self, decoding_cfg: dict) -> None:
        """greedy (the default) or beamsearch_ngram: prefix beam search with
        an optional n-gram LM in the native decoder (decode/ctc_beam.py; NeMo's
        ctc_decoders Scorer, beam_search_decoder.py:21-103). `beam` keys:
        beam_width, alpha, beta, lm_path (ARPA, its .binlm cache, or a KenLM
        .bin with kenlm_bin, kenlm_probing being its older spelling)."""
        strategy = decoding_cfg.get("strategy", "greedy")
        if strategy not in ("greedy", "beamsearch_ngram"):
            raise ValueError(f"unknown CTC decoding strategy {strategy!r}")
        self.raw_cfg["model"]["decoding"] = decoding_cfg
        self._beam_decoder = None

    def _get_beam_decoder(self) -> BeamSearchDecoderWithLM:
        if self._beam_decoder is None:
            beam = (self.raw_cfg["model"].get("decoding") or {}).get("beam") or {}
            vocab = self.tokenizer.ids_to_tokens(list(range(self.tokenizer.vocab_size)))
            self._beam_decoder = BeamSearchDecoderWithLM(
                vocab, beam_width=int(beam.get("beam_width", 64)),
                alpha=float(beam.get("alpha", 1.0)), beta=float(beam.get("beta", 1.5)),
                lm_path=beam.get("lm_path"),
                kenlm_bin=bool(beam.get("kenlm_bin", beam.get("kenlm_probing", False))))
            # SentencePiece pieces mark word starts with '▁'
            self._beam_is_spm = any(t.startswith("▁") for t in vocab)
        return self._beam_decoder

    @torch.inference_mode()
    def transcribe_with_timestamps(self, audio_paths: Sequence[str],
                                   batch_size: int = 16) -> List[List[WordTimestamp]]:
        """Per file, word timestamps from the greedy CTC frame alignments
        (decode/timestamps.py), whatever the decoding strategy; files sorted
        by length, `batch_size` rows a batch, as the JAX package's."""
        sr = self.raw_cfg["model"].get("sample_rate", 16000)
        time_per_frame = self.cfg.preprocessor.window_stride * frame_factor(self.cfg.encoder)
        wavs = [load_audio(p, target_sr=sr) for p in audio_paths]
        out = [None] * len(wavs)
        order = np.argsort([len(w) for w in wavs])
        for i in range(0, len(order), batch_size):
            idxs = order[i : i + batch_size]
            audio, lens = _pad_batch([wavs[j] for j in idxs], batch_size)
            log_probs, enc_lens = ctc_forward(self.model, torch.from_numpy(audio).to(self.device),
                                              torch.from_numpy(lens).to(self.device))
            aligns = ctc_frame_alignments(ctc_greedy_decode(log_probs).cpu().numpy(),
                                          enc_lens.cpu().numpy(), self.cfg.blank_id)
            for row, j in enumerate(idxs):
                out[j] = words_from_alignments(aligns[row], self.tokenizer, time_per_frame)
        return out

    @torch.no_grad()
    def transcribe_buffered(self, audio_paths: Sequence[str], frame_len: float = 1.6,
                            total_buffer: float = 4.0, batch_size: int = 4) -> List[str]:
        """Long audio in buffers (NeMo's FrameBatchASR, decode/streaming.py):
        each file's features in chunks of `frame_len` seconds, each chunk
        the end of a buffer of `total_buffer` seconds; `batch_size` buffers
        a forward (eval mode, the fixed buffer length), argmax; from each
        buffer the tokens_per_chunk predictions that end mid_delay frames
        before its end, merged with collapse-repeats. Memory stays bounded
        by the buffer whatever the file's length."""
        stride, tokens_per_chunk, mid_delay, feature_fn = self._buffered_setup(frame_len,
                                                                                total_buffer)
        self.model.eval()

        def forward_fn(feats: np.ndarray, lens: np.ndarray) -> np.ndarray:
            log_probs, _ = self.model(torch.from_numpy(feats).to(self.device),
                                      torch.from_numpy(lens).to(self.device))
            return log_probs.argmax(dim=-1).cpu().numpy()

        pre = self.cfg.preprocessor
        asr = FrameBatchASR(forward_fn, feature_fn, self.tokenizer, self.cfg.blank_id,
                            n_feat=pre.features, frame_len=frame_len, total_buffer=total_buffer,
                            batch_size=batch_size, window_stride=pre.window_stride,
                            sample_rate=self.raw_cfg["model"].get("sample_rate", 16000))
        return self._each_buffered(audio_paths, asr, mid_delay, stride,
                                   lambda a: a.transcribe(tokens_per_chunk, mid_delay))

    def _export_functions(self, batch_size: int, t_samples: int) -> dict:
        """One function, `forward`: (audio [B, T] f32, lens [B] int32) ->
        (log_probs, enc_lens) (NeMo's forward_for_export)."""
        return {"forward": (_CTCForward(self.model), self._audio_example(batch_size, t_samples))}

    @property
    def _encoder_config(self):
        return self.cfg.encoder

    def _init_state(self, optimizer):
        return init_ctc_state(self.model, optimizer, seed=self.seed)

    def _make_train_step(self, optimizer):
        """-> step(batch) -> metrics, over this model's training state."""
        step = make_ctc_train_step(
            self.cfg, optimizer,
            skip_nan_grad=bool(self.raw_cfg["model"].get("skip_nan_grad", False)))
        return lambda batch: step(self.train_state, batch)

    def _evaluate(self, loader, mesh: Optional[Mesh] = None) -> dict:
        return evaluate_wer(self.cfg, self.model, loader, self.tokenizer, mesh)

    def _to_jax(self, state_dict: dict) -> dict:
        return ctc_variables_to_jax(state_dict, self.cfg)

    def _from_jax(self, variables: dict) -> dict:
        return ctc_state_dict_from_jax(variables, self.cfg)

    @torch.inference_mode()
    def _decode_audio_batch(self, audio: np.ndarray, lens: np.ndarray, mode: str = "text"):
        strategy = (self.raw_cfg["model"].get("decoding") or {}).get("strategy", "greedy")
        if mode == "text" and strategy == "beamsearch_ngram":
            # the beam decodes the log-probs of every row on the host
            dec = self._get_beam_decoder()
            lps = self._decode_audio_batch(audio, lens, mode="logprobs")
            t_max = max(lp.shape[0] for lp in lps)
            nbest = dec(np.stack([np.pad(lp, ((0, t_max - lp.shape[0]), (0, 0))) for lp in lps]),
                        seq_lens=np.array([lp.shape[0] for lp in lps]))
            texts = [cands[0][0] if cands else "" for cands in nbest]
            if self._beam_is_spm:
                texts = [t.replace("▁", " ").strip() for t in texts]
            return texts
        log_probs, enc_lens = ctc_forward(self.model, torch.from_numpy(audio).to(self.device),
                                          torch.from_numpy(lens).to(self.device))
        enc_lens = enc_lens.cpu().numpy()
        if mode == "logprobs":
            lp = log_probs.cpu().numpy()
            return [lp[i, : enc_lens[i]] for i in range(audio.shape[0])]
        preds = ctc_greedy_decode(log_probs).cpu().numpy()
        id_lists = collapse_ctc_ids(preds, enc_lens, self.cfg.blank_id)
        if mode == "text":
            return [self.tokenizer.ids_to_text(ids) for ids in id_lists]
        frame_max = log_probs.max(dim=-1).values.cpu().numpy()
        return [
            TranscriptionHypothesis(
                score=float(frame_max[i, : enc_lens[i]].sum()), y_sequence=ids,
                text=self.tokenizer.ids_to_text(ids))
            for i, ids in enumerate(id_lists)
        ]


class ConformerTransducer(_BaseASRModel):
    """Conformer-Transducer: the encoder, an LSTM prediction network and the
    joint (models/rnnt.py); training through the RNN-T loss (the flash joint
    K4 and the lattice K3 on CUDA); transcription by the decoding config's
    strategy (decode/rnnt_decoding.py)."""

    def _build(self, dtype: torch.dtype) -> RNNTModel:
        self.cfg = build_rnnt_model_config(self.raw_cfg, vocab_size=self.tokenizer.vocab_size,
                                           dtype=dtype)
        check_flash_dtype(self.cfg.model.encoder, self.device)
        check_joint(self.cfg.model, self.device)
        model = RNNTModel(self.cfg.model)
        self.decoding = RNNTDecoding(model, self.tokenizer, self.raw_cfg["model"].get("decoding"))
        return model

    @property
    def _encoder_config(self):
        return self.cfg.model.encoder

    def change_decoding_strategy(self, decoding_cfg: dict) -> None:
        """Swap the decoding strategy without touching the weights: greedy,
        greedy_batch, beam, tsd, alsd, maes or beam_batch, with the config's
        `greedy` and `beam` blocks (NeMo's change_decoding_strategy,
        rnnt_models.py:403)."""
        self.decoding = RNNTDecoding(self.model, self.tokenizer, decoding_cfg)
        self.raw_cfg["model"]["decoding"] = decoding_cfg

    @torch.inference_mode()
    def transcribe_with_timestamps(self, audio_paths: Sequence[str],
                                   batch_size: int = 16) -> List[List[WordTimestamp]]:
        """Per file, word timestamps from the batched greedy decode's
        emission frames (the decoding config's max_symbols), whatever the
        strategy; files in the given order, `batch_size` a batch, as the JAX
        package's. A token emitted at frame t spans [t, t + 1); the JAX
        package gives it t + 1 frames (its `FrameAlignedToken` takes a
        length, and it passes t + 1), so its word ends run past the audio."""
        sr = self.raw_cfg["model"].get("sample_rate", 16000)
        stride = self.cfg.preprocessor.window_stride * frame_factor(self.cfg.model.encoder)
        wavs = [load_audio(p, target_sr=sr) for p in audio_paths]
        results = []
        for i in range(0, len(wavs), batch_size):
            chunk = wavs[i : i + batch_size]
            enc, enc_lens = self._encode(*_pad_batch(chunk, len(chunk)))
            toks, tlens, steps = (x.cpu().numpy() for x in rnnt_greedy_decode_batched(
                self.model, enc, enc_lens, max_symbols=self.decoding.max_symbols,
                return_timestamps=True))
            for row in range(len(chunk)):
                units = [FrameAlignedToken(int(toks[row, j]), int(steps[row, j]), 1)
                         for j in range(int(tlens[row]))]
                results.append(words_from_alignments(units, self.tokenizer, stride))
        return results

    @torch.no_grad()
    def transcribe_buffered(self, audio_paths: Sequence[str], frame_len: float = 1.6,
                            total_buffer: float = 4.0, batch_size: int = 4) -> List[str]:
        """Long audio in buffers (NeMo's LCS-merging BatchedFrameASRRNNT,
        decode/streaming.py): buffers as in ConformerCTC's, each batch
        encoded and decoded by batched greedy with the decoding config's
        max_symbols, each buffer's tokens joined to the file's at their
        longest common subsequence."""
        stride, _, mid_delay, feature_fn = self._buffered_setup(frame_len, total_buffer)
        self.model.eval()

        def decode_fn(feats: np.ndarray, lens: np.ndarray) -> tuple:
            enc, enc_lens = self.model.encode(torch.from_numpy(feats).to(self.device),
                                              torch.from_numpy(lens).to(self.device))
            toks, tlens = rnnt_greedy_decode_batched(self.model, enc, enc_lens,
                                                     max_symbols=self.decoding.max_symbols)
            return toks.cpu().numpy(), tlens.cpu().numpy()

        pre = self.cfg.preprocessor
        asr = BatchedFrameASRRNNT(decode_fn, feature_fn, self.tokenizer, n_feat=pre.features,
                                  frame_len=frame_len, total_buffer=total_buffer,
                                  batch_size=batch_size, window_stride=pre.window_stride,
                                  sample_rate=self.raw_cfg["model"].get("sample_rate", 16000))
        return self._each_buffered(audio_paths, asr, mid_delay, stride, lambda a: a.transcribe())

    def _export_functions(self, batch_size: int, t_samples: int) -> dict:
        """Two functions, as NeMo splits the transducer: `encoder`: (audio,
        lens) -> (enc [B, T', D], enc_lens); `decoder_joint`: (enc_t [B, D],
        last_label [B] int32, h, c [L, B, H]) -> (logits, h, c), one
        prediction-network step and the joint."""
        m = self.model
        d_out = m.joint.enc.in_features
        dcfg = self.cfg.model.decoder
        state = torch.zeros((dcfg.pred_rnn_layers, batch_size, dcfg.pred_hidden),
                            device=self.device)
        step_args = (torch.zeros((batch_size, d_out), device=self.device),
                     torch.full((batch_size,), dcfg.vocab_size, dtype=torch.int32,
                                device=self.device), state, state.clone())
        return {"encoder": (_Encoder(m.encoder, self.cfg.preprocessor),
                            self._audio_example(batch_size, t_samples)),
                "decoder_joint": (_DecoderJoint(m.decoder, m.joint), step_args)}

    def _to_jax(self, state_dict: dict) -> dict:
        """The bridge, with the LSTM biases taken from the model's own
        leaves: the state_dict's bias_ih less c may round (c + b loses the
        bits of a small leaf b)."""
        variables = rnnt_variables_to_jax(state_dict, self.cfg.model)
        lstm = self.model.decoder.prediction.dec_rnn.lstm
        for k in range(lstm.layers):
            variables["params"]["decoder"][f"lstm{k}_b"] = (
                getattr(lstm, f"bias_l{k}").detach().to("cpu", torch.float32).numpy())
        return variables

    def _from_jax(self, variables: dict) -> dict:
        """The bridge, with the LSTM biases loaded as the JAX leaves
        themselves (`bias_l{k}`) rather than through NeMo's bias pair."""
        sd = rnnt_state_dict_from_jax(variables, self.cfg.model)
        pre = "decoder.prediction.dec_rnn.lstm."
        for k in range(self.cfg.model.decoder.pred_rnn_layers):
            del sd[pre + f"bias_ih_l{k}"], sd[pre + f"bias_hh_l{k}"]
            sd[pre + f"bias_l{k}"] = torch.tensor(
                np.asarray(variables["params"]["decoder"][f"lstm{k}_b"], np.float32))
        return sd

    def _init_state(self, optimizer):
        return init_rnnt_state(self.model, optimizer, seed=self.seed)

    def _make_train_step(self, optimizer):
        """-> step(batch) -> metrics, over this model's training state."""
        step = make_rnnt_train_step(
            self.cfg, optimizer,
            skip_nan_grad=bool(self.raw_cfg["model"].get("skip_nan_grad", False)))
        return lambda batch: step(self.train_state, batch)

    def _evaluate(self, loader, mesh: Optional[Mesh] = None) -> dict:
        loss_step = (make_rnnt_loss_eval_step(self.cfg)
                     if self.raw_cfg["model"].get("compute_eval_loss", False) else None)
        return evaluate_rnnt_wer(
            self.cfg, self.model, loader, self.tokenizer,
            make_rnnt_eval_step(self.cfg, max_symbols=self.decoding.max_symbols),
            loss_step=loss_step, mesh=mesh)

    def _encode(self, audio: np.ndarray, lens: np.ndarray) -> tuple:
        """Padded waveforms -> the encoder's output [B, T, D] and lengths."""
        self.model.eval()
        feats, feat_lens = log_mel_spectrogram(self.cfg.preprocessor,
                                               torch.from_numpy(audio).to(self.device),
                                               torch.from_numpy(lens).to(self.device))
        return self.model.encode(feats, feat_lens)

    @torch.inference_mode()
    def _decode_audio_batch(self, audio: np.ndarray, lens: np.ndarray, mode: str = "text"):
        if mode == "logprobs":
            raise ValueError("logprobs=True is CTC-only (the transducer's transcribe has no "
                             "logprobs)")
        enc, enc_lens = self._encode(audio, lens)
        ids = self.decoding.decode(enc, enc_lens, preserve_alignments=mode == "hypotheses")
        if mode == "text":
            return [self.tokenizer.ids_to_text(seq) for seq in ids]
        # the greedy strategies keep emission frames, the beam ones none
        frames = self.decoding.last_alignments or [None] * len(ids)
        return [TranscriptionHypothesis(score=0.0, y_sequence=seq,
                                        text=self.tokenizer.ids_to_text(seq), timestep=fr)
                for seq, fr in zip(ids, frames)]
