"""JSONL manifests (port of conformer_nemo_tpu/data/manifest.py): one JSON
object per line with audio_filepath|audio_file, duration,
text|normalized_text|text_filepath, and optional offset and lang;
min/max-duration filtering, an optional cap on the count, optional
duration sort."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, List, Optional


@dataclasses.dataclass
class AudioTextSample:
    audio_file: str
    duration: float
    text: str
    offset: float = 0.0
    lang: Optional[str] = None


def _resolve_text(item: dict) -> str:
    if "text" in item:
        return item["text"]
    if "normalized_text" in item:
        return item["normalized_text"]
    if "text_filepath" in item:
        with open(item["text_filepath"], encoding="utf-8") as f:
            return f.read().strip()
    return ""


def iter_manifest(path: str) -> Iterator[AudioTextSample]:
    """Samples of one manifest; a relative audio path that exists next to
    the manifest resolves against the manifest's directory."""
    base = os.path.dirname(os.path.abspath(path))
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            item = json.loads(line)
            audio = item.get("audio_filepath") or item.get("audio_file")
            if audio is None:
                raise KeyError(f"manifest line missing audio_filepath: {line[:120]}")
            if not os.path.isabs(audio):
                cand = os.path.join(base, audio)
                if os.path.exists(cand):
                    audio = cand
            yield AudioTextSample(
                audio_file=audio,
                duration=float(item.get("duration", 0.0)),
                text=_resolve_text(item),
                offset=float(item.get("offset", 0.0) or 0.0),
                lang=item.get("lang"),
            )


def read_manifest(paths: str | List[str], min_duration: Optional[float] = None,
                  max_duration: Optional[float] = None, sort_by_duration: bool = False,
                  max_number: Optional[int] = None) -> List[AudioTextSample]:
    """Load and filter samples from one manifest, a comma-separated string
    of them, or a list."""
    if isinstance(paths, str):
        paths = [p for p in paths.split(",") if p]
    samples: List[AudioTextSample] = []
    for p in paths:
        for s in iter_manifest(p):
            if min_duration is not None and s.duration < min_duration:
                continue
            if max_duration is not None and s.duration > max_duration:
                continue
            samples.append(s)
            if max_number is not None and len(samples) >= max_number:
                break
    if sort_by_duration:
        samples.sort(key=lambda s: s.duration)
    return samples
