"""Serialized inference through `torch.export` (port of
conformer_nemo_tpu/utils/export.py, NeMo's `Exportable`).

Each function is traced once at static example shapes by
`torch.export.export` and saved with its weights by `torch.export.save`;
`load_exported` gives back callables that run the saved programs without
this package's model code. Shapes are static: export one function per
serving bucket, as the JAX package does.

The archive keeps the JAX package's layout, one tar.gz:

    manifest.json   {"format": "conformer_nemo_tpu_torch.pt2.v1",
                     "functions": {name: {"file", "in_avals"}}}
    <name>.pt2      the torch.export program

`in_avals` holds each input's shape and dtype as a string. A program holds
the tensors and the device of the example inputs it was traced on (the JAX
`platforms=` is the model's device here). The flash-attention forward is an
operator of this package (ops/flash_attention.py), so loading a program
that calls it imports that module: an exported model launches the
hand-written kernel on the card.
"""

from __future__ import annotations

import io
import json
import tarfile
from typing import Callable, Dict, Sequence

import torch
from torch import nn

# registers the operator conformer_nemo_tpu_torch::flash_attention_fwd,
# which programs exported from the encoder call
import conformer_nemo_tpu_torch.ops.flash_attention  # noqa: F401

FORMAT = "conformer_nemo_tpu_torch.pt2.v1"


class _Function(nn.Module):
    """A plain function as the module `torch.export` takes (its tensors are
    its inputs or constants: no parameters)."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_fn(fn, example_args: Sequence[torch.Tensor]) -> torch.export.ExportedProgram:
    """Trace `fn` (an nn.Module, whose parameters and buffers the program
    keeps, or a function of its inputs) at the example inputs' shapes,
    dtypes and device, without gradients."""
    mod = fn if isinstance(fn, nn.Module) else _Function(fn)
    with torch.no_grad():
        return torch.export.export(mod, tuple(example_args))


def _aval(x: torch.Tensor) -> str:
    """An input's dtype and shape as the JAX package writes them: "float32[2,8000]"."""
    return f"{str(x.dtype).removeprefix('torch.')}[{','.join(map(str, x.shape))}]"


def save_exported(path: str, functions: Dict[str, torch.export.ExportedProgram]) -> str:
    """Write the tar.gz of exported programs and their manifest."""
    manifest = {"format": FORMAT, "functions": {}}
    blobs = {}
    for name, program in functions.items():
        buf = io.BytesIO()
        torch.export.save(program, buf)
        fname = f"{name}.pt2"
        blobs[fname] = buf.getvalue()
        manifest["functions"][name] = {"file": fname,
                                       "in_avals": [_aval(x) for x in _inputs(program)]}
    # gzip's fastest level: weights barely compress, and level 9 costs
    # tens of seconds a function at full width
    with tarfile.open(path, "w:gz", compresslevel=1) as tar:
        for fname, data in [("manifest.json", json.dumps(manifest, indent=1).encode()),
                            *blobs.items()]:
            info = tarfile.TarInfo(fname)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return path


def _inputs(program: torch.export.ExportedProgram) -> list:
    """The example values (fake tensors) of a program's inputs."""
    from torch.export.graph_signature import InputKind

    names = [s.arg.name for s in program.graph_signature.input_specs
             if s.kind == InputKind.USER_INPUT]
    nodes = {n.name: n for n in program.graph.nodes if n.op == "placeholder"}
    return [nodes[n].meta["val"] for n in names]


def load_exported(path: str) -> Dict[str, Callable]:
    """An export archive -> {name: callable} (each runs its program
    without gradients)."""
    out: Dict[str, Callable] = {}
    with tarfile.open(path, "r:gz") as tar:
        manifest = json.loads(tar.extractfile("manifest.json").read())
        if manifest.get("format") != FORMAT:
            raise ValueError(f"{path}: not an archive of this package's exports "
                             f"(format {manifest.get('format')!r}, want {FORMAT!r})")
        for name, meta in manifest["functions"].items():
            program = torch.export.load(io.BytesIO(tar.extractfile(meta["file"]).read()))
            out[name] = _inference(program.module())
    return out


def _inference(module: nn.Module) -> Callable:
    def call(*args):
        with torch.no_grad():
            return module(*args)

    return call
