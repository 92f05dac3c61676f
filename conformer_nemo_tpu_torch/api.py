"""User API for serving: build a Conformer-CTC model and transcribe
(port of the `ConformerCTC` serving surface of conformer_nemo_tpu/api.py).

    model = ConformerCTC.from_config_file("configs/conformer_ctc_bpe.yaml",
                                          overrides={...})   # runs on CUDA
    model.load_state_dict(state_dict)   # NeMo names; see convert/jax_params.py
    texts = model.transcribe(["a.wav", "b.wav"])

Batching follows the JAX package: files up to `longform_threshold_s` are
sorted by length and decoded `batch_size` at a time, padded to a multiple
of 1600 samples and to `batch_size` rows with zero rows; each longer file
takes an exact whole-utterance forward alone, padded to threshold * 2^k.

Training (fit), save/restore, timestamps, buffered/streaming decode and
beam search with an LM wait for later slices (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from conformer_nemo_tpu_torch.config.loader import build_ctc_model_config, load_config
from conformer_nemo_tpu_torch.data.audio_io import load_audio
from conformer_nemo_tpu_torch.data.tokenizers import build_tokenizer
from conformer_nemo_tpu_torch.decode.ctc_greedy import collapse_ctc_ids, ctc_greedy_decode
from conformer_nemo_tpu_torch.device import resolve_device
from conformer_nemo_tpu_torch.models.conformer import check_flash_dtype
from conformer_nemo_tpu_torch.models.ctc_model import CTCModel, ctc_forward


@dataclasses.dataclass
class TranscriptionHypothesis:
    """Decode result: score, token ids, text (and timesteps, not ported yet)."""

    score: float
    y_sequence: List[int]
    text: str
    timestep: Optional[List[int]] = None


def _tokenizer_from_model_cfg(m: dict, tokenizer_dir: Optional[str] = None):
    if m.get("labels"):
        return build_tokenizer({"labels": m["labels"]})
    tok_cfg = dict(m.get("tokenizer") or {})
    if tokenizer_dir:
        tok_cfg["dir"] = tokenizer_dir
    return build_tokenizer(tok_cfg)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation with the JAX package's rules: LeCun-normal
    (truncated at two standard deviations) linear and convolution weights
    and zero biases. Norms, BatchNorm statistics and the rel-pos biases keep
    their construction values (unit scales, zero shifts, identity stats)."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # truncation correction
            nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()


class ConformerCTC:
    def __init__(self, raw_cfg: dict, tokenizer, dtype: torch.dtype = torch.bfloat16,
                 device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.raw_cfg = raw_cfg
        self.tokenizer = tokenizer
        self.cfg = build_ctc_model_config(raw_cfg, vocab_size=tokenizer.vocab_size, dtype=dtype)
        check_flash_dtype(self.cfg.encoder, self.device)
        model = CTCModel(self.cfg)
        init_weights(model, torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval()

    @classmethod
    def from_config_file(cls, path: str, tokenizer_dir: Optional[str] = None,
                         overrides: Optional[dict] = None, dtype: torch.dtype = torch.bfloat16,
                         device=None, seed: int = 0) -> "ConformerCTC":
        resolve_device(device)  # fail before any work when CUDA is missing
        raw = load_config(path, overrides)
        return cls(raw, _tokenizer_from_model_cfg(raw["model"], tokenizer_dir), dtype=dtype,
                   device=device, seed=seed)

    def state_dict(self) -> dict:
        return self.model.state_dict()

    def load_state_dict(self, state_dict: dict) -> None:
        """Load a state_dict with NeMo's names (e.g. from
        convert.jax_params.ctc_state_dict_from_jax)."""
        self.model.load_state_dict(state_dict, strict=True)

    def transcribe(self, audio_paths: Sequence[str], batch_size: int = 16,
                   logprobs: bool = False, return_hypotheses: bool = False,
                   longform_threshold_s: float = 60.0):
        """Offline transcription of audio files (eval mode, bucket-padded
        batches). `logprobs=True` returns per-file [T, V+1] numpy arrays;
        `return_hypotheses=True` returns TranscriptionHypothesis objects."""
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
            chunk = [wavs[j] for j in idxs]
            t_cap = int(math.ceil(max(len(w) for w in chunk) / 1600.0)) * 1600
            audio = np.zeros((batch_size, t_cap), np.float32)
            lens = np.zeros((batch_size,), np.int32)
            for row, w in enumerate(chunk):
                audio[row, : len(w)] = w
                lens[row] = len(w)
            results = self._decode_audio_batch(audio, lens, mode=mode)[: len(chunk)]
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

    @torch.inference_mode()
    def _decode_audio_batch(self, audio: np.ndarray, lens: np.ndarray, mode: str = "text"):
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
