"""Host-to-device batch prefetch (port of conformer_nemo_tpu/data/prefetch.py).

`device_prefetch` keeps `depth` batches in flight ahead of the consumer. A
thread takes each batch from the loader, copies its arrays into a pinned
host buffer and starts non-blocking copies to the card on a side stream,
recording an event after them. The consumer's stream waits on that event
before the batch is handed over (and the tensors are marked as used on the
consumer's stream, so the allocator does not reuse their memory early).
The batches are the loader's, in its order, with the same contents.

Pinned memory is a ring of depth + 1 buffers (one being filled, `depth` in
flight), each grown to the largest batch it has held in powers of two, so
buckets of different shapes do not pile up pinned blocks. A buffer is
refilled only after the copy out of it has finished.

On a CPU device the batches are converted in the consumer's thread.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from conformer_nemo_tpu_torch.data.dataset import Batch

_ARRAYS = ("audio", "audio_lens", "tokens", "token_lens")


def _on_cpu(batch: Batch, device: torch.device) -> Batch:
    return dataclasses.replace(batch, **{k: torch.as_tensor(getattr(batch, k)).to(device)
                                         for k in _ARRAYS})


class _PinnedSlot:
    """One pinned host buffer and the event of the last copy out of it."""

    def __init__(self):
        self.buf = torch.empty(0, dtype=torch.uint8)
        self.done = None

    def stage(self, arrays: dict) -> dict:
        """Copy the numpy arrays into this buffer -> {name: pinned view}."""
        if self.done is not None:
            self.done.synchronize()  # the last copy out of this buffer has finished
        sizes = {k: -(-a.nbytes // 64) * 64 for k, a in arrays.items()}  # 64-byte aligned
        need = sum(sizes.values())
        if need > self.buf.numel():
            self.buf = torch.empty(1 << (need - 1).bit_length(), dtype=torch.uint8,
                                   pin_memory=True)
        out, off = {}, 0
        for k, a in arrays.items():
            view = self.buf[off: off + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
            view = view.view(a.shape)
            view.numpy()[...] = a
            out[k] = view
            off += sizes[k]
        return out


def device_prefetch(batches: Iterable[Batch], device, depth: int = 2) -> Iterator[Batch]:
    """Yield each Batch of `batches` with its arrays as tensors on `device`,
    keeping `depth` batches in flight (CUDA) ahead of the consumer."""
    device = torch.device(device)
    if device.type != "cuda":
        for b in batches:
            yield _on_cpu(b, device)
        return
    side = torch.cuda.Stream(device=device)
    slots = [_PinnedSlot() for _ in range(depth + 1)]
    ready: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> None:
        while not stop.is_set():
            try:
                ready.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    source = iter(batches)

    def produce() -> None:
        try:
            for n, b in enumerate(source):
                if stop.is_set():
                    return
                slot = slots[n % len(slots)]
                arrays = {k: np.ascontiguousarray(getattr(b, k)) for k in _ARRAYS}
                pinned = slot.stage(arrays)
                with torch.cuda.stream(side):
                    on_dev = {k: v.to(device, non_blocking=True) for k, v in pinned.items()}
                    slot.done = torch.cuda.Event()
                    slot.done.record(side)
                put(("batch", dataclasses.replace(b, **on_dev), slot.done))
        except BaseException as e:  # surface the loader's errors in the consumer
            put(("error", e, None))
            return
        finally:
            close = getattr(source, "close", None)  # stop a generator's own workers
            if close is not None:
                close()
        put(("done", None, None))

    worker = threading.Thread(target=produce, name="h2d-prefetch", daemon=True)
    worker.start()
    try:
        while True:
            kind, payload, event = ready.get()
            if kind == "error":
                raise payload
            if kind == "done":
                return
            stream = torch.cuda.current_stream(device)
            stream.wait_event(event)
            for k in _ARRAYS:
                getattr(payload, k).record_stream(stream)
            yield payload
    finally:
        stop.set()
        worker.join(timeout=30.0)
