"""Audio -> label datasets for speech classification, VAD and speaker ID
(the JAX package's host numpy code, conformer_nemo_tpu/data/audio_to_label.py,
over the port's own audio decoder).

- Manifest rows carry a class label under `label` / `command` / `target`,
  with min/max duration filtering and a sorted unique label set.
- The fixed-length collate REPEATS signals shorter than the batch's fixed
  length (tail-slice remainder) to fill it, so pooling layers see no pad
  frames. The fixed length is a static `fixed_seconds`, so every batch has
  one shape.
- `vad_frame_slices`: an utterance zero-extended by half a window on each
  side, sliced into overlapping windows every shift.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from conformer_nemo_tpu_torch.data.audio_io import load_audio


@dataclasses.dataclass
class AudioLabelSample:
    audio_file: str
    duration: float
    label: str
    offset: float = 0.0


def iter_label_manifest(path: str) -> Iterator[AudioLabelSample]:
    base = os.path.dirname(os.path.abspath(path))
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            item = json.loads(line)
            audio = item.get("audio_filepath") or item.get("audio_file")
            label = item.get("label", item.get("command", item.get("target")))
            if audio is None or label is None:
                raise KeyError(f"manifest line missing audio/label: {line[:120]}")
            if not os.path.isabs(audio):
                cand = os.path.join(base, audio)
                if os.path.exists(cand):
                    audio = cand
            yield AudioLabelSample(
                audio_file=audio,
                duration=float(item.get("duration", 0.0)),
                label=str(label),
                offset=float(item.get("offset", 0.0) or 0.0),
            )


def read_label_manifest(
    path: str,
    min_duration: Optional[float] = None,
    max_duration: Optional[float] = None,
) -> List[AudioLabelSample]:
    out = []
    for s in iter_label_manifest(path):
        if min_duration and s.duration < min_duration:
            continue
        if max_duration and s.duration > max_duration:
            continue
        out.append(s)
    return out


def extract_labels(samples: Sequence[AudioLabelSample]) -> List[str]:
    """Sorted unique label set."""
    return sorted({s.label for s in samples})


def repeat_to_length(signal: np.ndarray, required: int) -> np.ndarray:
    """Repeat a signal (tail-slice remainder) to `required` samples
   ."""
    if len(signal) >= required:
        return signal[:required]
    repeat, rem = divmod(required, len(signal))
    parts = [signal] * repeat
    if rem:
        parts.append(signal[-rem:])
    return np.concatenate(parts)


def normalize_signal(signal: np.ndarray) -> np.ndarray:
    """Mean-removal + peak normalization."""
    centered = signal - signal.mean()
    peak = np.abs(centered).max()
    return centered / peak if peak > 0 else centered


class AudioToLabelDataset:
    """Manifest-backed label dataset; labels map to ids by sorted order."""

    def __init__(
        self,
        manifest: str,
        labels: Optional[Sequence[str]] = None,
        sample_rate: int = 16000,
        min_duration: Optional[float] = None,
        max_duration: Optional[float] = None,
        normalize_audio: bool = False,
        is_regression_task: bool = False,
    ):
        self.samples = read_label_manifest(manifest, min_duration, max_duration)
        self.is_regression_task = is_regression_task
        if is_regression_task:
            # targets are float values, no label<->id table
            self.labels, self.label2id, self.id2label = [], {}, {}
        else:
            self.labels = list(labels) if labels else extract_labels(self.samples)
            self.label2id = {l: i for i, l in enumerate(self.labels)}
            self.id2label = dict(enumerate(self.labels))
        self.sample_rate = sample_rate
        self.normalize_audio = normalize_audio

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, Any]:
        s = self.samples[i]
        wav = load_audio(
            s.audio_file, target_sr=self.sample_rate,
            offset=s.offset, duration=s.duration,
        )
        if self.normalize_audio:
            wav = normalize_signal(wav)
        if self.is_regression_task:
            return wav, float(s.label)
        return wav, self.label2id[s.label]


class FixedSeqLabelLoader:
    """Batches of (audio [B, T_fixed], lens [B], labels [B]) with the
    repeat-to-fixed-length collate. T_fixed = fixed_seconds * sample_rate
    (static: see the module docstring)."""

    def __init__(
        self,
        dataset: AudioToLabelDataset,
        batch_size: int,
        fixed_seconds: float = 8.0,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.t_fixed = int(round(fixed_seconds * dataset.sample_rate))
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self._epoch = 0

    def __iter__(self):
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(idx)
        self._epoch += 1
        idx = idx[self.process_index :: self.process_count]
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i : i + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                break
            audio = np.zeros((self.batch_size, self.t_fixed), np.float32)
            label_dtype = (np.float32 if getattr(self.ds, "is_regression_task",
                                                 False) else np.int32)
            labels = np.zeros((self.batch_size,), label_dtype)
            lens = np.full((self.batch_size,), self.t_fixed, np.int32)
            for row, j in enumerate(chunk):
                wav, lab = self.ds[int(j)]
                audio[row] = repeat_to_length(wav, self.t_fixed)
                labels[row] = lab
            # rows past len(chunk) are zeros with full length — callers slice
            yield audio, lens, labels, len(chunk)


def vad_frame_slices(
    signal: np.ndarray,
    sample_rate: int,
    window_sec: float = 0.31,
    shift_sec: float = 0.01,
    normalize: bool = False,
) -> np.ndarray:
    """Slice one utterance into overlapping VAD windows: zero-extend by
    window/2 on each side, then take [window]-sized slices every [shift].
    Returns [num_slices, window_samples]."""
    if normalize:
        signal = normalize_signal(signal)
    win = int(sample_rate * window_sec)
    shift = int(sample_rate * shift_sec)
    left, right = win // 2, win - win // 2
    sig = np.concatenate([np.zeros(left, signal.dtype), signal,
                          np.zeros(right, signal.dtype)])
    n = (len(sig) - win) // shift
    slices = np.stack([sig[k * shift : k * shift + win] for k in range(max(n, 1))])
    return slices
