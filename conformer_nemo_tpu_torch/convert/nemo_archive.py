"""Read NeMo `.nemo` archives and Lightning `.ckpt` files (port of
conformer_nemo_tpu/convert/nemo_archive.py; NeMo's
SaveRestoreConnector.restore_from).

A `.nemo` is a (possibly gzipped) tar of `model_config.yaml`,
`model_weights.ckpt` (a torch-serialised state_dict) and artifact files
(tokenizer models and vocabularies), which NeMo may store under md5-mangled
names (`<32 hex>_tokenizer.model`). The weights come back as CPU tensors
under NeMo's state_dict names, which are the port's (convert/nemo_state.py).
"""

from __future__ import annotations

import os
import tarfile
import tempfile
from typing import Optional

import torch
import yaml


class _AnyTagLoader(yaml.SafeLoader):
    """OmegaConf YAML may carry custom tags; map unknown tags to plain data."""


def _unknown(loader, tag_suffix, node):
    if isinstance(node, yaml.MappingNode):
        return loader.construct_mapping(node)
    if isinstance(node, yaml.SequenceNode):
        return loader.construct_sequence(node)
    return loader.construct_scalar(node)


_AnyTagLoader.add_multi_constructor("", _unknown)


def load_torch_weights(path: str) -> dict:
    """A torch checkpoint file -> flat {name: CPU tensor}: a raw state_dict
    (what a .nemo stores) or a Lightning checkpoint ({"state_dict": ...},
    whose other entries are dropped), a leading "model." stripped from
    each name and every non-tensor entry dropped. Full unpickling, as
    NeMo's checkpoints need: load only files you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj and not isinstance(
            next(iter(obj.values()), None), torch.Tensor):
        obj = obj["state_dict"]
    sd = {}
    for k, v in obj.items():
        if not isinstance(v, torch.Tensor):
            continue
        if k.startswith("model."):
            k = k[len("model."):]
        sd[k] = v.detach().cpu()
    return sd


def load_nemo_archive(path: str, extract_dir: Optional[str] = None):
    """-> (config dict, state {name: tensor}, {member name: extracted path}).

    Each artifact stored as `<md5>_name` is also registered under `name`,
    so that a caller finds 'tokenizer.model' whatever NeMo called it."""
    tmp = extract_dir or tempfile.mkdtemp(prefix="nemo_import_")
    with tarfile.open(path, "r:*") as tar:
        tar.extractall(tmp, filter="data")
    with open(os.path.join(tmp, "model_config.yaml"), encoding="utf-8") as f:
        config = yaml.load(f, Loader=_AnyTagLoader)
    state = load_torch_weights(os.path.join(tmp, "model_weights.ckpt"))
    artifacts = {}
    for name in os.listdir(tmp):
        if name in ("model_config.yaml", "model_weights.ckpt"):
            continue
        p = os.path.join(tmp, name)
        artifacts[name] = p
        parts = name.split("_", 1)
        if len(parts) == 2 and len(parts[0]) == 32 and parts[1] not in artifacts:
            artifacts[parts[1]] = p
    return config, state, artifacts


def strip_targets(node):
    """Drop Hydra's `_target_` reflection keys; keep the data."""
    if isinstance(node, dict):
        return {k: strip_targets(v) for k, v in node.items() if k != "_target_"}
    if isinstance(node, list):
        return [strip_targets(v) for v in node]
    return node
