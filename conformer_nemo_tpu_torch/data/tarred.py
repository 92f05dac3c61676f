"""Tarred-shard datasets, webdataset style (port of conformer_nemo_tpu/data/tarred.py).

Shard paths brace-expand (`audio_{0..127}.tar` or `audio__OP_0..127_CL_.tar`),
shards are read in a seeded order with the standard library's `tarfile` as
a stream, members match manifest entries by base name, and a ring buffer
of `shuffle_n` items shuffles within the stream. Across data-parallel
ranks the shards are partitioned as the JAX package partitions them:
`scatter` gives each rank a contiguous 1 / world_size of the expanded list
(which world_size must divide), `replicate` gives every rank every shard.
"""

from __future__ import annotations

import os
import re
import tarfile
from typing import Dict, Iterator, List, Optional

import numpy as np

from conformer_nemo_tpu_torch.data.audio_io import decode_audio_bytes, resample_poly
from conformer_nemo_tpu_torch.data.dataset import Batch, collate
from conformer_nemo_tpu_torch.data.manifest import AudioTextSample, read_manifest

_BRACE = re.compile(r"(\{|_OP_)(\d+)\.\.(\d+)(\}|_CL_)")


def expand_sharded_filepaths(paths, shard_strategy: str = "scatter", world_size: int = 1,
                             global_rank: int = 0) -> List[str]:
    """Brace-expanded shard paths, then rank `global_rank`'s part of them
    under `shard_strategy` (scatter | replicate)."""
    if shard_strategy not in ("scatter", "replicate"):
        raise ValueError(f"unknown shard_strategy: {shard_strategy}")
    if isinstance(paths, str):
        paths = [p for p in paths.split(",") if p]
    expanded: List[str] = []
    for p in paths:
        m = _BRACE.search(p)
        if m:
            expanded.extend(p[: m.start()] + str(i) + p[m.end():]
                            for i in range(int(m.group(2)), int(m.group(3)) + 1))
        else:
            expanded.append(p)
    if shard_strategy == "replicate":
        return expanded
    if len(expanded) % world_size != 0:
        raise ValueError(f"number of shards ({len(expanded)}) must be divisible by "
                         f"world_size ({world_size}) for the 'scatter' strategy")
    per = len(expanded) // world_size
    return expanded[global_rank * per: (global_rank + 1) * per]


class TarredAudioTextDataset:
    """Iterates (audio, ids, text) from tar shards through a shuffle ring
    buffer; the manifest gives each member's text (and `lang`), matched by
    base name."""

    def __init__(self, audio_tar_filepaths, manifest_filepath: str, tokenizer,
                 sample_rate: int = 16000, shuffle_n: int = 0,
                 min_duration: Optional[float] = None, max_duration: Optional[float] = None,
                 shard_strategy: str = "scatter", world_size: int = 1, global_rank: int = 0,
                 augmentor=None, seed: int = 0):
        self.shards = expand_sharded_filepaths(audio_tar_filepaths, shard_strategy, world_size,
                                               global_rank)
        self.tokenizer = tokenizer
        self.sample_rate = sample_rate
        self.shuffle_n = shuffle_n
        self.augmentor = augmentor
        self.seed = seed
        samples = read_manifest(manifest_filepath, min_duration=min_duration,
                                max_duration=max_duration)
        self.by_key: Dict[str, AudioTextSample] = {os.path.basename(s.audio_file): s
                                                   for s in samples}

    def _decode(self, data: bytes, name: str) -> np.ndarray:
        wav, sr = decode_audio_bytes(data, hint=name)
        if wav.ndim > 1:
            wav = wav.mean(axis=1)
        wav = resample_poly(wav, sr, self.sample_rate)
        if self.augmentor is not None:
            wav = self.augmentor.perturb(wav, self.sample_rate)
        return wav

    def _ids(self, s: AudioTextSample):
        if s.lang is not None and hasattr(self.tokenizer, "offsets"):
            return self.tokenizer.text_to_ids(s.text, s.lang)
        return self.tokenizer.text_to_ids(s.text)

    def __iter__(self) -> Iterator[tuple]:
        rng = np.random.RandomState(self.seed)
        shards = list(self.shards)
        rng.shuffle(shards)
        buffer: List[tuple] = []
        for shard in shards:
            with tarfile.open(shard, "r|*") as tf:  # a stream: members in order
                for member in tf:
                    meta = self.by_key.get(os.path.basename(member.name)) if member.isfile() \
                        else None
                    if meta is None:
                        continue
                    item = (self._decode(tf.extractfile(member).read(), member.name),
                            self._ids(meta), meta.text)
                    if self.shuffle_n > 1:
                        buffer.append(item)
                        if len(buffer) >= self.shuffle_n:
                            yield buffer.pop(rng.randint(len(buffer)))
                    else:
                        yield item
        rng.shuffle(buffer)
        yield from buffer


class TarredBatchIterator:
    """Fixed-shape batches (batch_size rows, max_samples_len samples,
    max_tokens tokens) from a TarredAudioTextDataset, in the wire format
    `transport`."""

    def __init__(self, dataset: TarredAudioTextDataset, batch_size: int, max_samples_len: int,
                 max_tokens: int, transport: Optional[str] = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.max_len = max_samples_len
        self.max_tokens = max_tokens
        self.transport = transport or "f32"

    def __iter__(self) -> Iterator[Batch]:
        buf = []
        for item in self.ds:
            buf.append(item)
            if len(buf) == self.batch_size:
                yield self._collate(buf)
                buf = []
        if buf:
            yield self._collate(buf)

    def _collate(self, items) -> Batch:
        return collate(items, self.max_len, self.max_tokens, self.batch_size, self.transport)
