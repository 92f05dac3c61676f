"""External-feature -> sequence-label datasets for speaker diarization
training (the JAX package's host numpy code,
conformer_nemo_tpu/data/feature_to_label.py).

- `load_external_feature`: precomputed features from .npy / .npz / pickle,
  integer dtypes scaled to [-1, 1] float32.
- Manifest rows `{"feature_filepath": ..., "seq_label": "spkA spkB ..."}`.
- Items are (features [T, D], feat_len, label_ids [U], label_len); the
  collate stacks without padding (the shapes must agree).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


def load_external_feature(path: str) -> np.ndarray:
    """np.load (npy / npz first array / pickle), integers scaled to [-1, 1]."""
    samples = np.load(path, allow_pickle=True)
    if isinstance(samples, np.lib.npyio.NpzFile):
        samples = samples[samples.files[0]]
    samples = np.asarray(samples)
    if np.issubdtype(samples.dtype, np.integer):
        bits = np.iinfo(samples.dtype).bits
        return samples.astype(np.float32) / float(2 ** (bits - 1))
    if np.issubdtype(samples.dtype, np.floating):
        return samples.astype(np.float32)
    raise TypeError(f"Unsupported feature dtype: {samples.dtype}")


@dataclasses.dataclass
class FeatureSeqLabelSample:
    feature_file: str
    seq_label: List[str]


def iter_feature_seq_manifest(path: str) -> Iterator[FeatureSeqLabelSample]:
    """JSONL rows with `feature_filepath`/`feature_filename` + space-separated
    `seq_label`."""
    base = os.path.dirname(os.path.abspath(path))
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            item = json.loads(line)
            feat = item.get("feature_filepath") or item.get("feature_filename")
            seq = item.get("seq_label")
            if feat is None or seq is None:
                raise ValueError(
                    f"manifest line missing feature file / seq_label: {line[:120]}")
            if not os.path.isabs(feat):
                cand = os.path.join(base, feat)
                if os.path.exists(cand):
                    feat = cand
            labels = seq.split() if isinstance(seq, str) else [str(s) for s in seq]
            yield FeatureSeqLabelSample(os.path.expanduser(feat), labels)


class FeatureToSeqSpeakerLabelDataset:
    """Precomputed features + per-frame speaker-label sequences."""

    def __init__(self, manifest: str, labels: Optional[Sequence[str]] = None):
        self.samples = list(iter_feature_seq_manifest(manifest))
        if labels:
            self.labels = list(labels)
        else:
            self.labels = sorted({l for s in self.samples for l in s.seq_label})
        self.label2id = {l: i for i, l in enumerate(self.labels)}
        self.id2label = dict(enumerate(self.labels))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int, np.ndarray, int]:
        s = self.samples[i]
        feats = load_external_feature(s.feature_file)
        ids = np.asarray([self.label2id[l] for l in s.seq_label], np.int32)
        return feats, feats.shape[0], ids, len(ids)


def feature_seq_collate(
    batch: Sequence[Tuple[np.ndarray, int, np.ndarray, int]],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stack a batch (a plain stack: the shapes must agree)."""
    feats = np.stack([b[0] for b in batch])
    feat_lens = np.asarray([b[1] for b in batch], np.int32)
    tokens = np.stack([b[2] for b in batch])
    token_lens = np.asarray([b[3] for b in batch], np.int32)
    return feats, feat_lens, tokens, token_lens


class FeatureSeqLabelLoader:
    """Minimal batching loader over `FeatureToSeqSpeakerLabelDataset` with
    per-process sharding (same discipline as FixedSeqLabelLoader)."""

    def __init__(self, dataset: FeatureToSeqSpeakerLabelDataset,
                 batch_size: int, shuffle: bool = False, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
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
            chunk = [self.ds[int(j)] for j in idx[i : i + self.batch_size]]
            if chunk:
                yield feature_seq_collate(chunk)
