"""Bucketed audio-text dataset and loader (port of
conformer_nemo_tpu/data/dataset.py).

Samples group into duration buckets whose boundaries sit at duration
quantiles rounded up to 0.1 s; every batch of a bucket has the same
(audio samples, token cap) shape and the bucket's batch size, short
batches padded with zero rows (audio_lens = 0, which the trainer weights
0). The epoch plan is a pure function of (seed, epoch, strategy), so the
serial path and the thread-pool path emit the same batches.

An item is decoded, optionally trimmed of silence and augmented (the
augmentor draws from a stream of (seed, epoch, index) alone, so the
batches do not depend on the worker count), and tokenized (with the
manifest's `lang` for an aggregate tokenizer, and bos/eos around the ids
with `use_start_end_token` where the tokenizer has them). The wire format
(`transport`) is f32, pcm16 (int16) or mulaw8 (int8 mu-law); the frontend
dequantises on the device (audio/features.py). Across data-parallel
ranks each loader takes every `process_count`-th sample of the shuffled
order from `process_index` on, as the JAX package's loader takes
`jax.process_index()`'s, before it fills the buckets. A training loader
(`drop_uneven`) then emits the least of the ranks' batch counts, which
every rank computes alone from the shared order, so that no rank waits in
a collective for one whose epoch has ended.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence

import numpy as np

from conformer_nemo_tpu_torch.data.audio_io import load_audio, load_audio_pcm16, mulaw8_encode
from conformer_nemo_tpu_torch.data.manifest import AudioTextSample

log = logging.getLogger(__name__)

TOKEN_CAP_PER_SEC = 8.0  # token cap of a bucket per second of its audio
MIN_TOKEN_CAP = 16
PREFETCH_BATCHES = 2  # collated batches the thread-pool path keeps ready
WIRE_DTYPES = {"f32": np.float32, "pcm16": np.int16, "mulaw8": np.int8}


@dataclasses.dataclass
class Batch:
    audio: np.ndarray  # [B, T] float32, int16 (pcm16) or int8 (mulaw8)
    audio_lens: np.ndarray  # [B] int32
    tokens: np.ndarray  # [B, U] int32
    token_lens: np.ndarray  # [B] int32
    texts: List[str]  # reference transcripts (host-side, for WER)


def make_bucket_boundaries(durations: Sequence[float], n_buckets: int,
                           sample_rate: int = 16000) -> List[int]:
    """Sample-count boundaries at duration quantiles, rounded up to 1600
    (0.1 s) multiples to bound the number of shapes."""
    if not durations:
        return [16 * sample_rate]
    qs = np.quantile(np.asarray(durations), np.linspace(1.0 / n_buckets, 1.0, n_buckets))
    out: List[int] = []
    for q in qs:
        samples = int(math.ceil(q * sample_rate / 1600.0)) * 1600
        if not out or samples > out[-1]:
            out.append(samples)
    return out


class BucketedAudioTextDataset:
    """Maps manifest samples to tokenized entries grouped by duration bucket."""

    def __init__(self, samples: List[AudioTextSample], tokenizer, sample_rate: int = 16000,
                 n_buckets: int = 8, trim_silence: bool = False,
                 use_start_end_token: bool = False, augmentor=None):
        self.samples = samples
        self.tokenizer = tokenizer
        self.sample_rate = sample_rate
        self.trim_silence = trim_silence
        self.augmentor = augmentor
        # the reference's AudioToBPEDataset wraps the ids with bos/eos where
        # the tokenizer defines them
        self.bos_id = getattr(tokenizer, "bos_id", None) if use_start_end_token else None
        self.eos_id = getattr(tokenizer, "eos_id", None) if use_start_end_token else None
        self.boundaries = make_bucket_boundaries([s.duration for s in samples], n_buckets,
                                                 sample_rate)
        # token cap per bucket: proportional to duration (rounded to 8)
        self.token_caps = [
            max(MIN_TOKEN_CAP, int(math.ceil(b / sample_rate * TOKEN_CAP_PER_SEC / 8.0)) * 8)
            for b in self.boundaries
        ]
        self.bucket_of = [self._bucket_index(int(round(s.duration * sample_rate)))
                          for s in samples]

    def _bucket_index(self, n_samples: int) -> int:
        for i, b in enumerate(self.boundaries):
            if n_samples <= b:
                return i
        return len(self.boundaries) - 1

    def encode_text(self, s: AudioTextSample) -> Optional[List[int]]:
        if s.lang is not None and hasattr(self.tokenizer, "offsets"):
            ids = self.tokenizer.text_to_ids(s.text, s.lang)
        else:
            ids = self.tokenizer.text_to_ids(s.text)
        if ids is not None:
            if self.bos_id is not None and self.bos_id >= 0:
                ids = [self.bos_id] + ids
            if self.eos_id is not None and self.eos_id >= 0:
                ids = ids + [self.eos_id]
        return ids

    def load_item(self, idx: int, rng: Optional[random.Random] = None, pcm16: bool = False):
        """Decode, trim, augment (drawing from `rng`) and tokenize one sample
        -> (audio [n], ids, text). With `pcm16` and neither trimming nor an
        augmentor the audio is int16 (`load_audio_pcm16`), else float32."""
        s = self.samples[idx]
        if pcm16 and self.augmentor is None and not self.trim_silence:
            audio = load_audio_pcm16(s.audio_file, target_sr=self.sample_rate, offset=s.offset,
                                     duration=s.duration)
            return audio, self.encode_text(s), s.text
        audio = load_audio(s.audio_file, target_sr=self.sample_rate, offset=s.offset,
                           duration=s.duration, trim=self.trim_silence)
        if self.augmentor is not None:
            audio = self.augmentor.perturb(audio, self.sample_rate, rng=rng)
        return audio, self.encode_text(s), s.text


class BucketedLoader:
    """Epoch iterator yielding fixed-shape Batches (token padding id 0) in
    the wire format `transport` (f32 | pcm16 | mulaw8).

    num_workers > 0 decodes items on a thread pool while a builder thread
    collates up to PREFETCH_BATCHES batches ahead of the consumer; the
    batches are the ones the serial path (num_workers = 0) emits."""

    def __init__(self, dataset: BucketedAudioTextDataset, batch_size: int, *,
                 shuffle: bool = True, seed: int = 0, process_index: int = 0,
                 process_count: int = 1, drop_uneven: bool = False,
                 bucketing_strategy: str = "synced_randomized", bucketing_batch_size=None,
                 num_workers: int = 0, transport: Optional[str] = None):
        transport = transport or "f32"
        if transport not in WIRE_DTYPES:
            raise ValueError(f"unknown transport {transport!r} (expected f32 | pcm16 | mulaw8)")
        self.transport = transport
        self.ds = dataset
        n_buckets = len(dataset.boundaries)
        if bucketing_batch_size is None:
            self.bucket_batch = [batch_size] * n_buckets
        elif isinstance(bucketing_batch_size, int):
            # a scale against the longest bucket: shorter buckets get larger batches
            longest = dataset.boundaries[-1]
            self.bucket_batch = [max(1, int(bucketing_batch_size * longest / b))
                                 for b in dataset.boundaries]
        else:
            if len(bucketing_batch_size) != n_buckets:
                raise ValueError(f"bucketing_batch_size needs {n_buckets} entries")
            self.bucket_batch = [int(x) for x in bucketing_batch_size]
        self.shuffle = shuffle
        self.seed = seed
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} is outside {process_count} processes")
        self.process_index = process_index
        self.process_count = process_count
        self.drop_uneven = drop_uneven
        self.bucketing_strategy = bucketing_strategy
        self.num_workers = int(num_workers or 0)
        self.epoch = 0
        self._plan_cache: Optional[tuple] = None

    def _plan(self) -> list[tuple[int, list[int]]]:
        """The epoch's batch plan: (bucket, sample indices) in emission order;
        a pure function of (seed, epoch, strategy), built once per epoch.
        With `drop_uneven`, cut to the least of the ranks' plan lengths."""
        if self._plan_cache is not None and self._plan_cache[0] == self.epoch:
            return self._plan_cache[1]
        batches = self._rank_plan(self.process_index)
        if self.drop_uneven and self.process_count > 1:
            n = min(len(self._rank_plan(r)) for r in range(self.process_count))
            if n < len(batches):
                log.info("loader: rank %d drops %d of its %d batches in epoch %d (a rank "
                         "has %d)", self.process_index, len(batches) - n, len(batches),
                         self.epoch, n)
            batches = batches[:n]
        self._plan_cache = (self.epoch, batches)
        return batches

    def _rank_plan(self, rank: int) -> list[tuple[int, list[int]]]:
        """Process `rank`'s whole plan of the epoch, as the JAX package's
        loader plans it: every process_count-th sample of the shuffled
        order from `rank` on, filled into buckets, the batches shuffled."""
        rng = np.random.RandomState(
            self.seed if self.bucketing_strategy == "synced_randomized"
            else self.seed + self.epoch)
        order = np.arange(len(self.ds.samples))
        if self.shuffle:
            rng.shuffle(order)
        order = order[rank:: self.process_count]
        pending: dict[int, list[int]] = {}
        batches: list[tuple[int, list[int]]] = []
        for idx in order:
            b = self.ds.bucket_of[idx]
            pending.setdefault(b, []).append(int(idx))
            if len(pending[b]) == self.bucket_batch[b]:
                batches.append((b, pending.pop(b)))
        batches.extend(pending.items())
        if self.shuffle:
            rng.shuffle(batches)
        return batches

    def __len__(self) -> int:
        return len(self._plan())

    def _item_rng(self, idx: int) -> random.Random:
        """An item's augmentation stream: a function of (seed, epoch, idx)
        only, as the JAX package's, so any worker count augments alike."""
        return random.Random((self.seed * 1000003 + self.epoch) * 1000003 + idx)

    def _load(self, idx: int):
        return self.ds.load_item(idx, rng=self._item_rng(idx),
                                 pcm16=self.transport in ("pcm16", "mulaw8"))

    def __iter__(self) -> Iterator[Batch]:
        """One epoch; the next starts whether this one ran to its end or was
        closed early (a max_steps stop)."""
        batches = self._plan()
        try:
            if self.num_workers > 0:
                yield from self._iter_workers(batches)
            else:
                for b, idxs in batches:
                    yield self._collate(b, idxs, [self._load(i) for i in idxs])
        finally:
            self.epoch += 1

    def _iter_workers(self, batches) -> Iterator[Batch]:
        """Decode on a thread pool, collate on a builder thread, and hand
        batches over through a bounded queue; closing the generator (a
        max_steps break) stops the builder."""
        out: queue.Queue = queue.Queue(maxsize=PREFETCH_BATCHES)
        stop = threading.Event()

        def put(item) -> None:
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def build() -> None:
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    inflight = []
                    plan = iter(batches)
                    for b, idxs in plan:
                        inflight.append((b, idxs, [pool.submit(self._load, i) for i in idxs]))
                        if len(inflight) > PREFETCH_BATCHES:
                            break
                    while inflight and not stop.is_set():
                        b, idxs, futs = inflight.pop(0)
                        put(("batch", self._collate(b, idxs, [f.result() for f in futs])))
                        nxt = next(plan, None)
                        if nxt is not None:
                            inflight.append((nxt[0], nxt[1], [pool.submit(self._load, i)
                                                              for i in nxt[1]]))
            except BaseException as e:  # surface worker errors in the consumer
                put(("error", e))
                return
            put(("done", None))

        builder = threading.Thread(target=build, name="bucketed-loader", daemon=True)
        builder.start()
        try:
            while True:
                kind, payload = out.get()
                if kind == "batch":
                    yield payload
                elif kind == "error":
                    raise payload
                else:
                    break
        finally:
            stop.set()
            builder.join(timeout=5.0)

    def _collate(self, bucket: int, idxs: List[int], items) -> Batch:
        # pad the batch dim too: fixed shapes
        return collate(items, self.ds.boundaries[bucket], self.ds.token_caps[bucket],
                       self.bucket_batch[bucket], self.transport)


def collate(items, t_cap: int, u_cap: int, bsz: int, transport: str = "f32") -> Batch:
    """(audio, ids, text) items -> a Batch of `bsz` rows (zero rows past the
    items) of t_cap samples in the wire format and u_cap tokens."""
    audio = np.zeros((bsz, t_cap), dtype=WIRE_DTYPES[transport])
    audio_lens = np.zeros((bsz,), dtype=np.int32)
    tokens = np.zeros((bsz, u_cap), dtype=np.int32)
    token_lens = np.zeros((bsz,), dtype=np.int32)
    texts: List[str] = []
    for row, (wav, toks, text) in enumerate(items):
        n = min(len(wav), t_cap)
        if transport == "mulaw8":
            audio[row, :n] = mulaw8_encode(wav[:n])
        elif transport == "pcm16" and wav.dtype != np.int16:
            audio[row, :n] = np.clip(wav[:n] * 32768.0, -32768, 32767).astype(np.int16)
        else:
            audio[row, :n] = wav[:n]
        audio_lens[row] = n
        toks = (toks or [])[:u_cap]
        tokens[row, : len(toks)] = toks
        token_lens[row] = len(toks)
        texts.append(text)
    texts.extend([""] * (bsz - len(texts)))
    return Batch(audio, audio_lens, tokens, token_lens, texts)
