"""The port's command-line entry points and config audit, on the CPU.

- the override grammar and the experiment manager built from a config
  equal the JAX package's scripts/common.py;
- `audit_config` flags the same key paths as the JAX package's on every
  configs/*.yaml and on a config with typos;
- `speech_to_text_ctc --device cpu +fast_dev_run=true`, `transcribe_speech`
  and `evaluate` run as subprocesses (tiny: 2 layers, d_model 64);
- `speech_to_text_ctc.main` in-process with an experiment manager writes
  the run dir, the checkpoints and a `.cntpu` archive that both packages
  restore; `speech_to_text_rnnt.main` takes one step;
- an unknown decoding strategy raises before any work, the beam and
  timestamp options run, and no entry point takes the CPU unless asked.
"""

import dataclasses
import glob
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from conformer_nemo_tpu.config import loader as jax_loader
from conformer_nemo_tpu_torch.api import ConformerCTC
from conformer_nemo_tpu_torch.config import loader
from conformer_nemo_tpu_torch.data.audio_io import write_wav
from conformer_nemo_tpu_torch.scripts import (
    common,
    evaluate,
    speech_to_text_ctc,
    speech_to_text_rnnt,
    transcribe_speech,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "conformer_ctc_bpe.yaml")
SP_MODEL = os.path.join(ROOT, "tests", "fixtures", "sp_bpe_bytefallback.model")
TINY = [f"model.tokenizer.model_file={SP_MODEL}", "model.encoder.n_layers=2",
        "model.encoder.d_model=64", "model.encoder.n_heads=4", "model.train_ds.batch_size=2",
        "model.validation_ds.batch_size=2"]


def _jax_scripts_common():
    spec = importlib.util.spec_from_file_location("jax_scripts_common",
                                                  os.path.join(ROOT, "scripts", "common.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(0)
    with open(d / "train.json", "w", encoding="utf-8") as f:
        for i, text in enumerate(["hello world", "the quick brown fox", "speech", "a test"]):
            n = int(rng.uniform(1.0, 2.0) * 16000)
            write_wav(str(d / f"{i}.wav"), (0.1 * rng.randn(n)).astype(np.float32))
            f.write(json.dumps({"audio_filepath": f"{i}.wav", "duration": n / 16000,
                                "text": text}) + "\n")
    return str(d / "train.json")


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """A tiny port model's `.cntpu` (BPE, the SentencePiece model inside)."""
    model = ConformerCTC.from_config_file(
        CONFIG, overrides=common.parse_overrides(TINY)[0], device="cpu", dtype=torch.float32)
    path = str(tmp_path_factory.mktemp("archive") / "tiny.cntpu")
    model.save_portable(path, artifacts=common.tokenizer_artifacts(model.raw_cfg))
    return path


def _run(module: str, *args) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return subprocess.run([sys.executable, "-m", f"conformer_nemo_tpu_torch.scripts.{module}",
                           *args], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


# ---------------------------------------------------------------------------
# the override grammar, the experiment manager, the audit
# ---------------------------------------------------------------------------


def test_override_grammar_matches_the_jax_scripts():
    argv = ["a.b=1", "+c.d=x", "e=true", "f=False", "g=null", "h=None", "i=0.5", "j=1e-3",
            "k=-3", "l=a=b", "--config", "x.yaml", "--flag", "m=", "n.o.p=run_1"]
    got = common.parse_overrides(argv)
    assert got == _jax_scripts_common().parse_overrides(argv)
    assert got[0]["a.b"] == 1 and got[0]["c.d"] == "x" and got[0]["e"] is True
    assert got[0]["g"] is None and got[0]["j"] == 1e-3 and got[0]["l"] == "a=b"
    assert got[1] == ["--config", "x.yaml", "--flag"]


def test_exp_manager_from_the_config_matches_the_jax_scripts(tmp_path):
    raw = {"name": "Conformer", "exp_manager": {
        "exp_dir": str(tmp_path), "resume_if_exists": True, "resume_ignore_no_checkpoint": True,
        "create_tensorboard_logger": False,
        "checkpoint_callback_params": {"monitor": "val_loss", "mode": "max", "save_top_k": 2,
                                       "always_save_nemo": False}}}
    port = common.build_exp_manager(raw)
    jax_em = _jax_scripts_common().build_exp_manager(raw)
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(jax_em.cfg)
    assert port.run_dir == jax_em.run_dir
    off = {"exp_manager": {"create_checkpoint_callback": False}}
    assert common.build_exp_manager(off) is None


def _flagged(msgs) -> list:
    return sorted(re.match(r"config key '([^']+)'", m).group(1) for m in msgs)


@pytest.mark.parametrize("name", sorted(os.path.basename(p) for p in
                                        glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
                         + ["typos"])
def test_audit_flags_the_jax_packages_key_paths(name):
    path = os.path.join(ROOT, "configs", "conformer_ctc_bpe.yaml" if name == "typos" else name)
    typos = ({"trainer.val_check_intervall": 0.5, "model.train_ds.batch_szie": 4,
              "exp_manager.resume_if_exist": True, "bogus_top": 1, "trainer.gpus": 1}
             if name == "typos" else None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cfg = loader.load_config(path, typos)
    port_msgs = loader.audit_config(cfg)
    want = _flagged(jax_loader.audit_config(jax_loader.load_config(path, typos, audit=False)))
    assert _flagged(port_msgs) == want
    assert sorted(_flagged(str(w.message) for w in caught
                           if issubclass(w.category, loader.ConfigKeyWarning))) == want
    if name == "typos":
        assert {"trainer.val_check_intervall", "model.train_ds.batch_szie",
                "exp_manager.resume_if_exist", "bogus_top", "trainer.gpus"} <= set(want)
    assert not any("jax" in m.lower() or "mesh" in m for m in port_msgs)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def test_ctc_training_cli_fast_dev_run_subprocess(manifest):
    r = _run("speech_to_text_ctc", "--config", CONFIG, "--device", "cpu", *TINY,
             f"model.train_ds.manifest_filepath={manifest}", "+fast_dev_run=true")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "done: {'steps': 1" in r.stdout


def test_ctc_training_cli_with_an_experiment_manager(manifest, tmp_path):
    from conformer_nemo_tpu.api import ConformerCTC as JaxConformerCTC

    model, result = speech_to_text_ctc.main([
        "--config", CONFIG, "--device", "cpu", *TINY,
        f"model.train_ds.manifest_filepath={manifest}",
        f"model.validation_ds.manifest_filepath={manifest}", "trainer.max_steps=2",
        "trainer.log_every_n_steps=1", f"exp_manager.exp_dir={tmp_path}",
        "exp_manager.create_tensorboard_logger=false",
        "exp_manager.checkpoint_callback_params.save_top_k=1"])
    assert result["steps"] == 2 and model.train_state.step == 2
    run_dir = os.path.join(str(tmp_path), model.raw_cfg["name"], "version_0")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows if "train_loss" in r] == [1, 2]
    assert all({"grad_norm", "train_step_timing"} <= set(r) for r in rows if "train_loss" in r)
    ckpts = os.path.join(run_dir, "checkpoints")
    with open(os.path.join(ckpts, "step_2", "meta.json")) as f:
        assert json.load(f)["step"] == 2
    with open(os.path.join(ckpts, "last")) as f:
        assert f.read() == "step_2"
    archive = os.path.join(run_dir, model.raw_cfg["name"] + ".cntpu")
    wav = os.path.join(os.path.dirname(manifest), "0.wav")
    texts = model.transcribe([wav])
    assert ConformerCTC.restore_portable(archive, dtype=torch.float32,
                                         device="cpu").transcribe([wav]) == texts
    import jax.numpy as jnp

    assert JaxConformerCTC.restore_portable(archive, dtype=jnp.float32).transcribe([wav]) == texts


def test_rnnt_training_cli_one_step(manifest):
    model, result = speech_to_text_rnnt.main([
        "--config", os.path.join(ROOT, "configs", "conformer_transducer_bpe.yaml"),
        "--device", "cpu", *TINY, "model.model_defaults.pred_hidden=32",
        "model.model_defaults.joint_hidden=32", "model.decoding.greedy.max_symbols=2",
        f"model.train_ds.manifest_filepath={manifest}", "+fast_dev_run=true"])
    assert result["steps"] == 1 and model.train_state.step == 1


def test_transcribe_and_evaluate_subprocesses(archive, manifest, tmp_path):
    model = ConformerCTC.restore_portable(archive, device="cpu")
    wavs = [os.path.join(os.path.dirname(manifest), f"{i}.wav") for i in range(2)]
    texts = model.transcribe(wavs)
    out = str(tmp_path / "hyps.jsonl")
    r = _run("transcribe_speech", "--model", archive, "--device", "cpu", "--audio", *wavs,
             "--output", out)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.splitlines() == [f"{p}\t{t}" for p, t in zip(wavs, texts)]
    with open(out) as f:
        assert [json.loads(line)["pred_text"] for line in f] == texts
    r = _run("evaluate", "--model", archive, "--device", "cpu", "--manifest", manifest, "--cer")
    assert r.returncode == 0, r.stderr[-3000:]
    assert re.match(r"CER: \d\.\d{4}  \(4 utts\)", r.stdout)


def test_entry_points_refuse_before_any_work(archive, manifest):
    missing = "/nonexistent/model.cntpu"  # never opened: the refusal comes first
    with pytest.raises(ValueError, match="unknown CTC decoding strategy"):  # as the JAX one
        evaluate.main(["--model", missing, "--manifest", manifest, "--decoding-strategy", "x"])
    for strategy in ("beam", "beamsearch_ngram_typo"):
        with pytest.raises(ValueError, match="unknown CTC decoding strategy"):
            evaluate.main(["--model", missing, "--manifest", manifest,
                           "--decoding-strategy", strategy])
    with pytest.raises(ValueError, match="unknown RNN-T decoding strategy"):
        evaluate.main(["--model", missing, "--manifest", manifest, "--model-type", "rnnt",
                       "--decoding-strategy", "beamsearch_ngram"])
    if not torch.cuda.is_available():
        for extra in ([], ["--timestamps", "--ctm-dir", "ctm"]):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                transcribe_speech.main(["--model", archive, "--audio", "a.wav", *extra])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            evaluate.main(["--model", archive, "--manifest", manifest,
                           "--decoding-strategy", "beamsearch_ngram"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            speech_to_text_ctc.main(["--config", CONFIG, *TINY])


def test_beam_and_timestamp_options_run(archive, manifest, tmp_path, capsys):
    """The options that raised before the decoding slice now run: the CTC
    beam with and without an ARPA LM, and the word timestamps with a CTM
    directory, on the CPU."""
    lm = str(tmp_path / "lm.arpa")  # a copy: the decoder writes its cache beside it
    shutil.copy(os.path.join(ROOT, "tests", "fixtures", "lm_edge.arpa"), lm)
    for extra in (["--decoding-strategy", "beamsearch_ngram"],
                  ["--decoding-strategy", "beamsearch_ngram", "--lm-path", lm, "--beam-size", "8"],
                  ["--lm-path", lm]):  # an LM without the beam strategy: greedy, as in JAX
        wer = evaluate.main(["--model", archive, "--device", "cpu", "--manifest", manifest, *extra])
        assert 0.0 <= wer < float("inf")
    wavs = [os.path.join(os.path.dirname(manifest), f"{i}.wav") for i in range(2)]
    ctm = str(tmp_path / "ctm")
    texts = transcribe_speech.main(["--model", archive, "--device", "cpu", "--audio", *wavs,
                                    "--timestamps", "--ctm-dir", ctm])
    assert len(texts) == 2 and sorted(os.listdir(ctm)) == ["0.ctm", "1.ctm"]
    assert capsys.readouterr().out.count("wrote ") == 2
