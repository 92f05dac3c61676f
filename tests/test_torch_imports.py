"""The port stands alone: no module of conformer_nemo_tpu_torch, and not
chip_smoke.py, imports JAX, the JAX package, msgpack (the port reads and
writes flax's msgpack format itself) or Hugging Face `tokenizers` (the port
reads and trains `tokenizer.json` itself); its native host libraries (the
codecs and the CTC beam decoder) build from its own sources and nothing
loads from or reads the JAX package's `native/`; and no entry point runs
on the CPU unless asked."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "msgpack", "conformer_nemo_tpu", "tokenizers"):
    sys.modules[name] = None  # any import of these now raises ImportError
import conformer_nemo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(conformer_nemo_tpu_torch.__path__,
                                               "conformer_nemo_tpu_torch.")]
for name in names:
    importlib.import_module(name)
parallel = {"conformer_nemo_tpu_torch.parallel." + m for m in ("distributed", "mesh", "sharding")}
assert parallel <= set(names), sorted(parallel - set(names))
streaming = {"conformer_nemo_tpu_torch." + m for m in (
    "decode.streaming", "utils.export", "convert.nemo_archive", "convert.nemo_state",
    "scripts.convert_nemo")}
assert streaming <= set(names), sorted(streaming - set(names))
labels = {"conformer_nemo_tpu_torch." + m for m in (
    "api_ssl", "api_label", "models.ssl", "models.conv_asr", "models.tdnn",
    "models.classification", "ops.contrastive_loss", "ops.classification_losses",
    "data.audio_to_label", "data.feature_to_label", "decode.vad", "scripts.ssl_pretrain",
    "scripts.speech_classification", "scripts.speaker_tasks")}
assert labels <= set(names), sorted(labels - set(names))
rest = {"conformer_nemo_tpu_torch." + m for m in (
    "decode.der", "decode.diarization", "decode.asr_diar", "audio.mfcc", "models.rnn_encoder",
    "utils.typecheck", "utils.timers", "utils.profiling", "data.bpe_trainer",
    "scripts.train_tokenizer")}
assert rest <= set(names), sorted(rest - set(names))
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                                               "msgpack")
                and sys.modules[m] is not None)
assert not leaked, leaked
# every library the decoders load comes from the port's own build (scipy,
# which resamples, probes sys.modules for jax: drop the import blocks first)
for name in ("jax", "jaxlib", "flax", "optax", "msgpack", "conformer_nemo_tpu", "tokenizers"):
    del sys.modules[name]
import ctypes, os, tempfile
loaded = []
real_cdll = ctypes.CDLL.__init__
def spy(self, name, *a, **kw):
    loaded.append(str(name))
    real_cdll(self, name, *a, **kw)
ctypes.CDLL.__init__ = spy
from conformer_nemo_tpu_torch.data import audio_io, codecs, flac_encode
x = audio_io.load_audio("tests/fixtures/speech/utt1.flac")
tmp = tempfile.mkdtemp()
for ext, write in ((".ogg", codecs.write_ogg), (".opus", codecs.write_opus), (".mp3", codecs.write_mp3)):
    write(os.path.join(tmp, "a" + ext), x)
    audio_io.load_audio(os.path.join(tmp, "a" + ext))
from conformer_nemo_tpu_torch.decode.ctc_beam import BeamSearchDecoderWithLM
BeamSearchDecoderWithLM(["a", " "], lm_path="tests/fixtures/lm_edge.arpa", lm_binary_cache=False)
assert not [p for p in loaded if "native" in p.split(os.sep)], loaded
assert any(p.endswith("ops/_build/libflac_decoder.so") for p in loaded), loaded
assert any(p.endswith("ops/_build/libctc_beam.so") for p in loaded), loaded
from conformer_nemo_tpu_torch.decode.wer import edit_distance
assert edit_distance("kitten", "sitting") == 3
assert any(p.endswith("ops/_build/libedit_distance.so") for p in loaded), loaded
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "conformer_nemo_tpu")]
print(len(names))
"""


def test_port_imports_without_jax_or_the_jax_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    r = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    # every module was walked: the decoders, the multi-GPU modules, buffered
    # decode, export, the .nemo converter, SSL, the label models,
    # diarization, the RNN encoder, MFCC, the utilities and the tokenizer
    # trainer included
    assert int(r.stdout.split()[-1]) >= 90


def test_no_port_source_reads_the_jax_packages_native_tree():
    """No port module or native source names `native/` (the JAX package's
    C sources and its build directory); the host libraries build from the
    port's data/csrc into its own ignored build directory."""
    from conformer_nemo_tpu_torch.ops import build

    port = os.path.join(ROOT, "conformer_nemo_tpu_torch")
    offenders = []
    for dirpath, _, files in os.walk(port):
        for name in files:
            if name.endswith((".py", ".c", ".cpp", ".cu", ".cuh")):
                with open(os.path.join(dirpath, name), encoding="utf-8") as f:
                    text = f.read()
                if "native/" in text or '"native"' in text or "native_dir" in text:
                    offenders.append(os.path.relpath(os.path.join(dirpath, name), ROOT))
    with open(os.path.join(ROOT, "chip_smoke.py"), encoding="utf-8") as f:
        if "native/" in f.read():
            offenders.append("chip_smoke.py")
    assert not offenders, offenders
    assert build.HOST_CSRC_DIR == os.path.join(port, "data", "csrc")
    assert build.BUILD_DIR == os.path.join(port, "ops", "_build")
    for source, _, _, headers in build.HOST_LIBS.values():
        for f in (source, *headers):
            assert os.path.isfile(os.path.join(build.HOST_CSRC_DIR, f)), f
    assert "ctc_beam" in build.HOST_LIBS


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
    from conformer_nemo_tpu_torch.scripts import convert_nemo

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert_nemo.convert("model.nemo", "model.cntpu")  # before it reads the file
    assert resolve_device("cpu") == torch.device("cpu")


def test_ssl_and_label_entry_points_raise_without_cuda():
    """The SSL and label models, their restores and the three CLIs default
    to CUDA too, and raise before any work without it."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    from conformer_nemo_tpu_torch import api_label, api_ssl
    from conformer_nemo_tpu_torch.scripts import (
        speaker_tasks,
        speech_classification,
        ssl_pretrain,
    )

    for make in (api_ssl.SpeechSSLModel, lambda: api_label.ClassificationModel(["a", "b"]),
                 api_label.RegressionModel, lambda: api_label.SpeakerLabelModel(["a", "b"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    for cls in (api_label.ClassificationModel, api_label.RegressionModel,
                api_label.SpeakerLabelModel):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls.restore_portable("model.cntpu")  # before it reads the file
    for main, argv in ((ssl_pretrain.main, ["--config", os.path.join(
            ROOT, "configs", "conformer_ctc_bpe.yaml"), "model.train_ds.manifest_filepath=m.json"]),
                       (speech_classification.main, ["--model", "model.cntpu"]),
                       (speaker_tasks.main, ["embed", "--model", "model.cntpu", "a.wav"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
    assert api_label.ClassificationModel(["a", "b"], device="cpu").device == torch.device("cpu")


def test_diarization_rnn_encoder_and_mfcc_raise_without_cuda():
    """The diarizer (given a speaker archive), the RNN encoder's and the LSTM
    head's `create`, `mfcc` and the speaker CLI's diarize mode default to
    CUDA too, and raise before any work without it; score mode needs no
    device."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    import numpy as np

    from conformer_nemo_tpu_torch.audio.mfcc import MFCCConfig, mfcc
    from conformer_nemo_tpu_torch.decode.diarization import ClusteringDiarizer
    from conformer_nemo_tpu_torch.models.rnn_encoder import (
        LSTMDecoder,
        LSTMDecoderConfig,
        RNNEncoder,
        RNNEncoderConfig,
    )
    from conformer_nemo_tpu_torch.scripts import speaker_tasks

    wav, lens = np.zeros((1, 1600), np.float32), np.array([1600], np.int32)
    for make in (lambda: ClusteringDiarizer("model.cntpu"),  # before it reads the file
                 lambda: RNNEncoder.create(RNNEncoderConfig()),
                 lambda: LSTMDecoder.create(LSTMDecoderConfig()),
                 lambda: mfcc(MFCCConfig(), wav, lens),
                 lambda: speaker_tasks.main(["diarize", "--model", "model.cntpu", "a.wav"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    out, _ = mfcc(MFCCConfig(), wav, lens, device="cpu")
    assert out.device == torch.device("cpu")


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
