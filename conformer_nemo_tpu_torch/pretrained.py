"""Pretrained-model registry: name -> local `.cntpu` archive (port of
conformer_nemo_tpu/pretrained.py).

The same names as the JAX package's registry (the reference NeMo model
classes' published names) and the same cache search: a direct path, then
`<cache_dir>/<name>.cntpu`, `$CONFORMER_NEMO_TPU_CACHE/<name>.cntpu` and
`~/.cache/conformer_nemo_tpu/<name>.cntpu`. The archive format is shared,
so one cache serves both packages. Resolution is local only (nothing is
downloaded), with the JAX package's error text.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class PretrainedModelInfo:
    """Mirror of the reference PretrainedModelInfo (common.py:452-...)."""

    pretrained_model_name: str
    description: str
    location: str = ""  # original NGC URL (informational only; no egress here)
    class_name: str = ""


# Published names from the reference model classes (ctc_models.py:55-150,
# ctc_bpe_models.py:127-167, rnnt_bpe_models.py). WERs cited in descriptions
# are the reference docstrings' claims, kept verbatim for traceability.
REGISTRY: dict[str, tuple[PretrainedModelInfo, ...]] = {
    "ConformerCTC": (
        PretrainedModelInfo(
            "QuartzNet15x5Base-En",
            "QuartzNet15x5 trained on six datasets; 3.79% WER LibriSpeech "
            "dev-clean / 10.05% dev-other (reference ctc_models.py:55)",
            class_name="ConformerCTC",
        ),
        PretrainedModelInfo(
            "stt_en_conformer_ctc_small",
            "Conformer-CTC small (13M) BPE English (reference ctc_bpe_models.py:127)",
            class_name="ConformerCTC",
        ),
        PretrainedModelInfo(
            "stt_en_conformer_ctc_medium",
            "Conformer-CTC medium (30M) BPE English",
            class_name="ConformerCTC",
        ),
        PretrainedModelInfo(
            "stt_en_conformer_ctc_large",
            "Conformer-CTC large (121M) BPE English",
            class_name="ConformerCTC",
        ),
        PretrainedModelInfo(
            "stt_en_conformer_ctc_small_ls",
            "Conformer-CTC small, LibriSpeech-only",
            class_name="ConformerCTC",
        ),
        PretrainedModelInfo(
            "stt_en_conformer_ctc_medium_ls",
            "Conformer-CTC medium, LibriSpeech-only",
            class_name="ConformerCTC",
        ),
        PretrainedModelInfo(
            "stt_en_conformer_ctc_large_ls",
            "Conformer-CTC large, LibriSpeech-only",
            class_name="ConformerCTC",
        ),
    ),
    "ConformerTransducer": (
        PretrainedModelInfo(
            "stt_en_conformer_transducer_large",
            "Conformer-Transducer large (120M) BPE English",
            class_name="ConformerTransducer",
        ),
        PretrainedModelInfo(
            "stt_zh_conformer_transducer_large",
            "Conformer-Transducer large Mandarin (reference ctc_models.py:145-150)",
            class_name="ConformerTransducer",
        ),
    ),
}

_ENV_CACHE = "CONFORMER_NEMO_TPU_CACHE"


def cache_dirs() -> list[str]:
    """Search path for pretrained archives, highest priority first."""
    dirs = []
    env = os.environ.get(_ENV_CACHE)
    if env:
        dirs.append(env)
    dirs.append(os.path.join(os.path.expanduser("~"), ".cache", "conformer_nemo_tpu"))
    return dirs


def list_available_models(class_name: str) -> Sequence[PretrainedModelInfo]:
    return REGISTRY.get(class_name, ())


def resolve_pretrained(name: str, cache_dir: Optional[str] = None) -> str:
    """Resolve a pretrained-model name (or direct path) to an archive path.

    Accepts either a filesystem path to a `.cntpu` archive, or a registry
    name looked up as `<cache>/<name>.cntpu` in `cache_dir`, then
    `$CONFORMER_NEMO_TPU_CACHE`, then `~/.cache/conformer_nemo_tpu/`.
    """
    if os.path.isfile(name):
        return name
    dirs = ([cache_dir] if cache_dir else []) + cache_dirs()
    candidates = [os.path.join(d, f"{name}.cntpu") for d in dirs]
    for c in candidates:
        if os.path.isfile(c):
            return c
    known = sorted(i.pretrained_model_name for v in REGISTRY.values() for i in v)
    hint = (
        f"'{name}' is a known model name; " if name in known else f"'{name}' is not a registered name; "
    )
    raise FileNotFoundError(
        hint
        + "no archive found. This environment has no network egress, so "
        + "pretrained archives must be placed locally: looked for "
        + ", ".join(candidates)
        + f". Known names: {', '.join(known)}."
    )
