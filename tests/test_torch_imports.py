"""The port stands alone: no module of conformer_nemo_tpu_torch, and not
chip_smoke.py, imports JAX, the JAX package or msgpack (the port reads and
writes flax's msgpack format itself); and no entry point runs on the CPU
unless asked."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "msgpack", "conformer_nemo_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import conformer_nemo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(conformer_nemo_tpu_torch.__path__,
                                               "conformer_nemo_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                                               "msgpack")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax_or_the_jax_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    r = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert int(r.stdout.split()[-1]) >= 46  # every module was walked


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    from conformer_nemo_tpu_torch import resolve_device
    from conformer_nemo_tpu_torch.api import ConformerCTC, ConformerTransducer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ConformerCTC.from_config_file(
            os.path.join(ROOT, "configs", "conformer_ctc_bpe.yaml"),
            overrides={"model.tokenizer.model_file": os.path.join(
                ROOT, "tests", "fixtures", "sp_bpe_bytefallback.model")})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ConformerTransducer.from_config_file(
            os.path.join(ROOT, "configs", "conformer_transducer_bpe.yaml"),
            overrides={"model.tokenizer.model_file": os.path.join(
                ROOT, "tests", "fixtures", "sp_bpe_bytefallback.model")})
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
