"""Buffered (chunked) streaming inference (port of
conformer_nemo_tpu/decode/streaming.py, after NeMo's streaming_utils.py).

  * AudioFeatureIterator: whole-utterance features streamed as fixed-width
    frame chunks, the last one zero-padded.
  * FeatureFrameBufferer: a ring buffer of `total_buffer` seconds, shifted
    by `frame_len` a step, initialised to the log-mel of a zero signal
    (-16.635); each buffer normalised by the mean and std of a running
    feature buffer.
  * FrameBatchASR: batched CTC forwards over buffers; `transcribe` keeps
    tokens_per_chunk tokens ending `delay` before each buffer's end (the
    middle of its context) and merges them with collapse-repeats.
  * longest_common_subsequence_merge / BatchedFrameASRRNNT: transducer
    chunks aligned and joined at their longest common subsequence.

Host code in numpy, as the JAX package has it, so that the buffers equal
its buffers bit for bit; the forward or decode it is given runs the model
on its device.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np

ZERO_LEVEL_SPEC_DB_VAL = -16.635  # log-mel of zero signal (streaming_utils.py:466)


class AudioFeatureIterator:
    """Features for the whole signal, iterated in frame_len-second chunks."""

    def __init__(self, samples: np.ndarray, frame_len: float, feature_fn: Callable,
                 window_stride: float):
        """feature_fn: samples [T] -> feats [D, Tf] (un-normalized, no dither)."""
        self._feature_frame_len = int(frame_len / window_stride)
        feats = feature_fn(samples)
        self._features = np.asarray(feats)
        self._features_len = self._features.shape[1]
        self._start = 0
        self.output = True

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if not self.output:
            raise StopIteration
        last = self._start + self._feature_frame_len
        if last <= self._features_len:
            frame = self._features[:, self._start : last].copy()
            self._start = last
        else:
            frame = np.zeros(
                (self._features.shape[0], self._feature_frame_len), dtype=np.float32
            )
            remain = self._features_len - self._start
            if remain > 0:
                frame[:, :remain] = self._features[:, self._start :]
            self.output = False
        return frame


class FeatureFrameBufferer:
    """Ring buffer of feature frames with per-chunk normalization consts."""

    def __init__(self, n_feat: int, frame_len: float, total_buffer: float,
                 window_stride: float, batch_size: int = 4):
        self.n_frame_len = int(frame_len / window_stride)
        self.buffer_len = int(total_buffer / window_stride)
        self.n_feat = n_feat
        self.batch_size = batch_size
        self.reset()

    def reset(self):
        self.buffer = np.full((self.n_feat, self.buffer_len), ZERO_LEVEL_SPEC_DB_VAL, np.float32)
        self.feature_buffer = np.full(
            (self.n_feat, self.buffer_len), ZERO_LEVEL_SPEC_DB_VAL, np.float32
        )
        self.signal_end = False
        self.frame_reader = None

    def set_frame_reader(self, frame_reader):
        self.frame_reader = frame_reader
        self.signal_end = False

    def _get_batch_frames(self) -> List[np.ndarray]:
        if self.signal_end:
            return []
        out = []
        for frame in self.frame_reader:
            out.append(frame.copy())
            if len(out) == self.batch_size:
                return out
        self.signal_end = True
        return out

    def _update_feature_buffer(self, frame):
        n = frame.shape[1]
        self.feature_buffer[:, :-n] = self.feature_buffer[:, n:]
        self.feature_buffer[:, -n:] = frame

    def get_buffers_batch(self) -> List[np.ndarray]:
        """-> list of normalized [D, buffer_len] buffers (may be empty)."""
        frames = self._get_batch_frames()
        buffers = []
        for frame in frames:
            self.buffer[:, : -self.n_frame_len] = self.buffer[:, self.n_frame_len :]
            self.buffer[:, -self.n_frame_len :] = frame
            self._update_feature_buffer(frame)
            mean = self.feature_buffer.mean(axis=1, keepdims=True)
            std = self.feature_buffer.std(axis=1, keepdims=True) + 1e-5
            buffers.append(((self.buffer - mean) / std).astype(np.float32))
        return buffers


class FrameBatchASR:
    """Chunked CTC inference with middle-token merge.

    forward_fn: (feats [B, D, T], lens [B]) -> argmax predictions [B, T'].
    """

    def __init__(
        self,
        forward_fn: Callable,
        feature_fn: Callable,
        tokenizer,
        blank_id: int,
        n_feat: int = 80,
        frame_len: float = 1.6,
        total_buffer: float = 4.0,
        batch_size: int = 4,
        window_stride: float = 0.01,
        sample_rate: int = 16000,
    ):
        self.forward_fn = forward_fn
        self.feature_fn = feature_fn
        self.tokenizer = tokenizer
        self.blank_id = blank_id
        self.frame_len = frame_len
        self.window_stride = window_stride
        self.sample_rate = sample_rate
        self.bufferer = FeatureFrameBufferer(
            n_feat, frame_len, total_buffer, window_stride, batch_size
        )
        self.reset()

    def reset(self):
        self.all_preds: List[np.ndarray] = []
        self.bufferer.reset()

    def read_audio_samples(self, samples: np.ndarray, delay: float, model_stride_in_secs: float):
        samples = np.pad(samples, (0, int(delay * model_stride_in_secs * self.sample_rate)))
        reader = AudioFeatureIterator(
            samples, self.frame_len, self.feature_fn, self.window_stride
        )
        self.bufferer.set_frame_reader(reader)

    def infer_logits(self):
        buffers = self.bufferer.get_buffers_batch()
        while buffers:
            feats = np.stack(buffers)  # [b, D, T]
            lens = np.full((feats.shape[0],), feats.shape[-1], np.int32)
            preds = np.asarray(self.forward_fn(feats, lens))
            for row in preds:
                self.all_preds.append(row)
            buffers = self.bufferer.get_buffers_batch()

    def transcribe(self, tokens_per_chunk: int, delay: int) -> str:
        self.infer_logits()
        unmerged: List[int] = []
        for pred in self.all_preds:
            decoded = pred.tolist()
            start = len(decoded) - 1 - delay
            unmerged += decoded[start : start + tokens_per_chunk]
        return self.greedy_merge(unmerged)

    def greedy_merge(self, preds: List[int]) -> str:
        decoded = []
        previous = self.blank_id
        for p in preds:
            if (p != previous or previous == self.blank_id) and p != self.blank_id:
                decoded.append(int(p))
            previous = p
        return self.tokenizer.ids_to_text(decoded)


def longest_common_subsequence_merge(x: List[int], y: List[int], max_lcs_len: int = 0):
    """Merge overlapping token streams at their LCS alignment point
    (NeMo's streaming_utils.py:68): the tokens of `y` to append after `x`.

    x = accumulated tokens; y = next chunk's tokens (overlapping prefix
    expected to align with a suffix of x). The LCS table row by row in
    numpy, keeping one row: row i is the running maximum of (the previous
    row shifted, plus one, where x[i] matches) and the previous row, the
    same integers as the JAX package's cell-by-cell table, in time O(|x|)
    numpy passes, which a transducer's chunks of thousands of tokens need."""
    if not x:
        return y
    if not y:
        return []
    ya = np.asarray(y)
    row = np.zeros(len(y) + 1, dtype=np.int32)  # dp[i, :], dp[i, 0] = 0
    for xi in x:
        row[1:] = np.maximum.accumulate(np.where(ya == xi, row[:-1] + 1, row[1:]))
    # the alignment end in y: a long match, a short consumed prefix; the
    # last j of the best score, as the JAX package's `>=` scan picks it
    score = 2 * row.astype(np.int64) - np.arange(len(y) + 1)
    best_j = len(y) - int(np.argmax(score[::-1]))
    return y[best_j:]


class BatchedFrameASRRNNT:
    """Chunked RNNT inference with LCS overlap merging.

    decode_fn: (feats [B, D, T], lens [B]) -> (tokens [B, U], token_lens [B]).
    """

    def __init__(
        self,
        decode_fn: Callable,
        feature_fn: Callable,
        tokenizer,
        n_feat: int = 80,
        frame_len: float = 1.6,
        total_buffer: float = 4.0,
        batch_size: int = 4,
        window_stride: float = 0.01,
        sample_rate: int = 16000,
    ):
        self.decode_fn = decode_fn
        self.feature_fn = feature_fn
        self.tokenizer = tokenizer
        self.frame_len = frame_len
        self.window_stride = window_stride
        self.sample_rate = sample_rate
        self.bufferer = FeatureFrameBufferer(
            n_feat, frame_len, total_buffer, window_stride, batch_size
        )
        self.reset()

    def reset(self):
        self.merged: List[int] = []
        self.bufferer.reset()

    def read_audio_samples(self, samples: np.ndarray, delay: float, model_stride_in_secs: float):
        samples = np.pad(samples, (0, int(delay * model_stride_in_secs * self.sample_rate)))
        reader = AudioFeatureIterator(
            samples, self.frame_len, self.feature_fn, self.window_stride
        )
        self.bufferer.set_frame_reader(reader)

    def transcribe(self) -> str:
        buffers = self.bufferer.get_buffers_batch()
        while buffers:
            feats = np.stack(buffers)
            lens = np.full((feats.shape[0],), feats.shape[-1], np.int32)
            tokens, tlens = self.decode_fn(feats, lens)
            tokens, tlens = np.asarray(tokens), np.asarray(tlens)
            for i in range(tokens.shape[0]):
                chunk = tokens[i, : int(tlens[i])].tolist()
                self.merged += longest_common_subsequence_merge(self.merged, chunk)
            buffers = self.bufferer.get_buffers_batch()
        return self.tokenizer.ids_to_text(self.merged)
