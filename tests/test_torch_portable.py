"""`.cntpu` archives across the two packages, on the CPU (fp32, tiny: 2
layers, d_model 64; the transducer's prediction and joint width 32).

- JAX -> port: the JAX package's `ConformerCTC` / `ConformerTransducer`
  (perturbed initial weights and BatchNorm statistics; char labels, and
  BPE with the SentencePiece model as an artifact) run `save_portable`;
  the port's `restore_portable(device="cpu")` must give CTC log-probs (or
  the transducer's joint outputs on the same encoder input and targets)
  within 1e-4 absolute of the JAX model's, and the same greedy texts.
- port -> JAX: the same, the other way.
- each package lists and reads the other's archive: the same members and
  the same weights tree, leaf for leaf.
- the transducer's LSTM bias travels as JAX keeps it (without
  forget_gate_bias c): back in the port the forget chunk b is within one
  ulp of max(|b|, |b - c|), every other tensor bit for bit.
- a legacy params-only archive; an HF tokenizer.json artifact and an
  aggregate tokenizer both ways; and `from_pretrained` through
  `cache_dir` and `$CONFORMER_NEMO_TPU_CACHE`.
"""

import os
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from conformer_nemo_tpu.api import ConformerCTC as JaxConformerCTC
from conformer_nemo_tpu.api import ConformerTransducer as JaxConformerTransducer
from conformer_nemo_tpu.models.rnnt import RNNTModel as JaxRNNTModel
from conformer_nemo_tpu.train import checkpoint as jax_ckpt
from conformer_nemo_tpu_torch.api import ConformerCTC, ConformerTransducer
from conformer_nemo_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
SP_MODEL = os.path.join(FIXTURES, "sp_bpe_bytefallback.model")
WAVS = [os.path.join(FIXTURES, "speech", f) for f in ("utt0.wav", "utt2.wav", "utt4.wav")]
ENC = {"model.encoder.n_layers": 2, "model.encoder.d_model": 64, "model.encoder.n_heads": 4,
       "model.encoder.conv_kernel_size": 15}
RNNT = {"model.model_defaults.pred_hidden": 32, "model.model_defaults.joint_hidden": 32,
        "model.decoding.greedy.max_symbols": 3}
CASES = {
    ("ctc", "char"): ("conformer_ctc_char.yaml", ENC),
    ("ctc", "bpe"): ("conformer_ctc_bpe.yaml", {**ENC, "model.tokenizer.model_file": SP_MODEL}),
    ("rnnt", "char"): ("conformer_transducer_char.yaml", {**ENC, **RNNT}),
    ("rnnt", "bpe"): ("conformer_transducer_bpe.yaml",
                      {**ENC, **RNNT, "model.tokenizer.model_file": SP_MODEL}),
}
ATOL = 1e-4
ARTIFACTS = {"tokenizer_model": SP_MODEL}


def _classes(kind):
    return ((JaxConformerCTC, ConformerCTC) if kind == "ctc"
            else (JaxConformerTransducer, ConformerTransducer))


def _jax_model(kind, tok, seed=0):
    """The JAX model with perturbed initial weights and statistics."""
    name, overrides = CASES[(kind, tok)]
    jm = _classes(kind)[0].from_config_file(os.path.join(ROOT, "configs", name),
                                            overrides=overrides, dtype=jnp.float32)
    state = jm._init_state(jm._make_optimizer())
    rng = np.random.RandomState(seed)
    noisy = lambda x: np.asarray(x, np.float32) + 0.2 * rng.randn(*np.shape(x)).astype(np.float32)
    stats = state.batch_stats
    if stats:
        stats = jax.tree.map(lambda x: jnp.asarray(np.abs(noisy(x)) + 0.5), stats)
    jm.state = state.replace(params=jax.tree.map(lambda x: jnp.asarray(noisy(x)), state.params),
                             batch_stats=stats)
    return jm


def _port_model(kind, tok, seed=0):
    """The port's model with perturbed weights and statistics."""
    name, overrides = CASES[(kind, tok)]
    pm = _classes(kind)[1].from_config_file(os.path.join(ROOT, "configs", name),
                                            overrides=overrides, device="cpu",
                                            dtype=torch.float32, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in pm.model.parameters():
            p.add_(0.2 * torch.randn(p.shape, generator=gen))
        for name_, b in pm.model.named_buffers():
            if name_.endswith(("running_mean", "running_var")):
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
    return pm


def _artifacts(tok):
    return ARTIFACTS if tok == "bpe" else None


def _feats_and_targets(jm_or_pm_cfg_vocab: int):
    rng = np.random.RandomState(3)
    feats = rng.randn(2, 80, 40).astype(np.float32)
    lens = np.array([40, 31], np.int32)
    tgt = rng.randint(0, jm_or_pm_cfg_vocab, (2, 4)).astype(np.int32)
    return feats, lens, tgt


def _jax_joint(jm, feats, lens, tgt) -> np.ndarray:
    model = JaxRNNTModel(jm.cfg.model)
    variables = {"params": jm.state.params}
    if jm.state.batch_stats:
        variables["batch_stats"] = jm.state.batch_stats
    enc, _ = model.apply(variables, jnp.asarray(feats), jnp.asarray(lens),
                         method=JaxRNNTModel.encode)
    g = model.apply(variables, jnp.asarray(tgt), method=JaxRNNTModel.predict)
    return np.asarray(model.apply(variables, enc, g, method=lambda m, e, p: m.joint(e, p)))


@torch.no_grad()
def _port_joint(pm, feats, lens, tgt) -> np.ndarray:
    pm.model.eval()
    enc, _ = pm.model.encode(torch.from_numpy(feats), torch.from_numpy(lens))
    return pm.model.joint(enc, pm.model.decoder(torch.from_numpy(tgt))).numpy()


def _assert_same_outputs(kind, jm, pm):
    kw = dict(batch_size=2)
    assert pm.transcribe(WAVS, **kw) == jm.transcribe(WAVS, **kw)
    if kind == "ctc":
        for a, b in zip(pm.transcribe(WAVS, logprobs=True, **kw),
                        jm.transcribe(WAVS, logprobs=True, **kw)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=ATOL)
    else:
        args = _feats_and_targets(jm.tokenizer.vocab_size)
        np.testing.assert_allclose(_port_joint(pm, *args), _jax_joint(jm, *args), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("kind,tok", sorted(CASES))
def test_jax_archive_restores_in_the_port(kind, tok, tmp_path):
    jm = _jax_model(kind, tok)
    path = str(tmp_path / "jax.cntpu")
    jm.save_portable(path, artifacts=_artifacts(tok))
    pm = _classes(kind)[1].restore_portable(path, dtype=torch.float32, device="cpu")
    _assert_same_outputs(kind, jm, pm)


@pytest.mark.parametrize("kind,tok", sorted(CASES))
def test_port_archive_restores_in_jax(kind, tok, tmp_path):
    pm = _port_model(kind, tok)
    path = str(tmp_path / "port.cntpu")
    pm.save_portable(path, artifacts=_artifacts(tok))
    jm = _classes(kind)[0].restore_portable(path, dtype=jnp.float32)
    _assert_same_outputs(kind, jm, pm)
    back = _classes(kind)[1].restore_portable(path, dtype=torch.float32, device="cpu")
    want, got = pm.state_dict(), back.state_dict()
    assert set(want) == set(got)
    for k in want:  # the port's LSTM bias round trip is exact in the Sterbenz range
        assert torch.equal(want[k], got[k]), k


def test_each_package_lists_and_reads_the_others_archive(tmp_path):
    jm, pm = _jax_model("ctc", "bpe"), _port_model("ctc", "bpe")
    paths = {"jax": str(tmp_path / "jax.cntpu"), "port": str(tmp_path / "port.cntpu")}
    jm.save_portable(paths["jax"], artifacts=ARTIFACTS)
    pm.save_portable(paths["port"], artifacts=ARTIFACTS)
    # the JAX package stores the SentencePiece model under its base name;
    # the port stores it as tokenizer.model (its config drops model_file)
    sp_name = {"jax": os.path.basename(SP_MODEL), "port": "tokenizer.model"}
    for who, path in paths.items():
        with tarfile.open(path, "r:gz") as tar:
            assert sorted(tar.getnames()) == sorted(
                ["model_config.yaml", "model_weights.msgpack", "artifacts.json", sp_name[who]])
        cfg_p, tree_p, arts_p = ckpt.load_portable(path, extract_dir=str(tmp_path / "p"))
        cfg_j, tree_j, arts_j = jax_ckpt.load_portable(path, extract_dir=str(tmp_path / "j"))
        assert cfg_p == cfg_j
        assert ("model_file" in cfg_p["model"]["tokenizer"]) == (who == "jax")
        assert {k: os.path.basename(v) for k, v in arts_p.items()} == {
            k: os.path.basename(v) for k, v in arts_j.items()} == {"tokenizer_model":
                                                                   sp_name[who]}
        flat_p = jax.tree_util.tree_leaves_with_path(tree_p)
        flat_j = jax.tree_util.tree_leaves_with_path(tree_j)
        assert [p for p, _ in flat_p] == [p for p, _ in flat_j]
        for (key, a), (_, b) in zip(flat_p, flat_j):
            assert a.dtype == b.dtype and np.array_equal(a, b), key
    # the port's tree has the JAX model's structure: flax restores into it
    restored = serialization.from_state_dict(
        {"params": jm.state.params, "batch_stats": jm.state.batch_stats},
        ckpt.load_portable(paths["port"])[1])
    assert jax.tree.structure(restored) == jax.tree.structure(
        {"params": jm.state.params, "batch_stats": jm.state.batch_stats})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_archive_restores_once_the_tokenizer_file_is_gone(writer, tmp_path):
    """A BPE model built with model.tokenizer.model_file, archived, then
    restored where that file no longer exists (another machine). The port's
    archive carries the model as tokenizer.model and restores in both
    packages; the JAX package's archive keeps the path (a condition of the
    reference side), and the port reads the archive's file of that name."""
    machine = tmp_path / "machine"
    machine.mkdir()
    sp = str(machine / "sp.model")
    with open(SP_MODEL, "rb") as src, open(sp, "wb") as dst:
        dst.write(src.read())
    model = _jax_model("ctc", "bpe") if writer == "jax" else _port_model("ctc", "bpe")
    model.raw_cfg["model"]["tokenizer"]["model_file"] = sp
    path = str(tmp_path / f"{writer}.cntpu")
    model.save_portable(path, artifacts={"tokenizer_model": sp})
    os.remove(sp)
    pm = ConformerCTC.restore_portable(path, dtype=torch.float32, device="cpu")
    if writer == "jax":
        _assert_same_outputs("ctc", model, pm)
    else:
        _assert_same_outputs("ctc", JaxConformerCTC.restore_portable(path, dtype=jnp.float32), pm)
        assert pm.transcribe(WAVS, batch_size=2) == model.transcribe(WAVS, batch_size=2)


@pytest.mark.parametrize("leaf", ["far_from_c", "small"])
def test_lstm_forget_chunk_round_trip(leaf, tmp_path):
    """The archive holds the port's LSTM bias leaf L (NeMo's b less c =
    forget_gate_bias) itself, and the restore loads it as the leaf: port ->
    JAX -> port gives L back bit for bit, for leaves far from c (NeMo
    biases -3..7, out of [c/2, 2c]) and for small ones, whose low bits
    fl(L + c) drops (through the state_dict, fl(fl(L + c) - c) is not L);
    every tensor of the state_dict bit for bit.
    The BatchNorm statistics travel too (the port's BatchNorm keeps no
    num_batches_tracked, so there is no counter to carry)."""
    pm = _port_model("rnnt", "bpe")
    lstm = pm.model.decoder.prediction.dec_rnn.lstm
    h = pm.cfg.model.decoder.pred_hidden
    c = pm.cfg.model.decoder.forget_gate_bias
    with torch.no_grad():
        lstm.bias_l0[h: 2 * h] = (torch.linspace(-3.0, 7.0, h) - c if leaf == "far_from_c"
                                  else torch.linspace(-1e-3, 1e-3, h) + 1.2345678e-4)
    if leaf == "small":  # what the state_dict alone would give back
        rounded = (lstm.bias_l0[h: 2 * h] + c) - c
        assert not torch.equal(rounded, lstm.bias_l0[h: 2 * h])
    path = str(tmp_path / "lstm.cntpu")
    pm.save_portable(path, artifacts=ARTIFACTS)
    back = ConformerTransducer.restore_portable(path, dtype=torch.float32, device="cpu")
    assert torch.equal(back.model.decoder.prediction.dec_rnn.lstm.bias_l0, lstm.bias_l0)
    want, got = pm.state_dict(), back.state_dict()
    assert not any(k.endswith("num_batches_tracked") for k in want)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k


def test_legacy_params_only_archive(tmp_path):
    """A params-only archive restores; the BatchNorm statistics keep their
    construction values, as the JAX package keeps its initial ones."""
    pm = _port_model("ctc", "bpe")
    path = str(tmp_path / "legacy.cntpu")
    ckpt.save_portable(path, pm.raw_cfg, pm.portable_variables["params"], ARTIFACTS)
    back = ConformerCTC.restore_portable(path, dtype=torch.float32, device="cpu")
    fresh = ConformerCTC.from_config_file(os.path.join(ROOT, "configs", "conformer_ctc_bpe.yaml"),
                                          overrides=CASES[("ctc", "bpe")][1], device="cpu",
                                          dtype=torch.float32)
    for k, v in back.state_dict().items():
        src = fresh if k.endswith(("running_mean", "running_var")) else pm
        assert torch.equal(v, src.state_dict()[k]), k
    jm = JaxConformerCTC.restore_portable(path, dtype=jnp.float32)
    np.testing.assert_allclose(back.transcribe(WAVS[:1], logprobs=True)[0],
                               np.asarray(jm.transcribe(WAVS[:1], logprobs=True)[0]),
                               rtol=0, atol=ATOL)


def test_restore_refuses_what_is_not_ported(tmp_path):
    """An HF `tokenizer` artifact and an aggregate tokenizer, once refused,
    now restore in the port as in the JAX package (the same texts and
    log-probs); an archive with no tokenizer artifact still raises."""
    from conformer_nemo_tpu.data.tokenizers import train_bpe_tokenizer
    from conformer_nemo_tpu_torch.scripts.common import tokenizer_artifacts

    hf_dir = tmp_path / "hf"
    hf_dir.mkdir()
    with open(os.path.join(FIXTURES, "sp_corpus.txt"), encoding="utf-8") as f:
        train_bpe_tokenizer([line.strip() for line in f], 120, str(hf_dir / "tokenizer.json"))
    agg = {f"model.tokenizer.langs.{lang}.model_file": os.path.join(FIXTURES, name)
           for lang, name in (("en", "sp_bpe_bytefallback.model"), ("es", "sp_unigram.model"))}
    for name, config, overrides in (
            ("hf", "conformer_ctc_bpe.yaml", {**ENC, "model.tokenizer.dir": str(hf_dir)}),
            ("agg", "conformer_ctc_bpe_multilang.yaml", {**ENC, **agg})):
        pm = ConformerCTC.from_config_file(os.path.join(ROOT, "configs", config),
                                           overrides=overrides, device="cpu",
                                           dtype=torch.float32)
        with torch.no_grad():
            gen = torch.Generator().manual_seed(2)
            for p in pm.model.parameters():
                p.add_(0.2 * torch.randn(p.shape, generator=gen))
        artifacts = tokenizer_artifacts(pm.raw_cfg)
        assert ("tokenizer" in artifacts) == (name == "hf")
        path = str(tmp_path / f"{name}.cntpu")
        pm.save_portable(path, artifacts)
        _assert_same_outputs("ctc", JaxConformerCTC.restore_portable(path, dtype=jnp.float32),
                             ConformerCTC.restore_portable(path, dtype=torch.float32,
                                                           device="cpu"))
    pm = _port_model("ctc", "bpe")
    path = str(tmp_path / "none.cntpu")
    ckpt.save_portable(path, pm.raw_cfg, pm.portable_variables)
    with pytest.raises(ValueError, match="no tokenizer artifact"):
        ConformerCTC.restore_portable(path, device="cpu")


def test_from_pretrained_through_the_local_cache(tmp_path, monkeypatch):
    from conformer_nemo_tpu_torch import pretrained

    assert [i.pretrained_model_name for i in ConformerCTC.list_available_models()] == [
        i.pretrained_model_name for i in JaxConformerCTC.list_available_models()]
    assert "stt_en_conformer_transducer_large" in [
        i.pretrained_model_name for i in ConformerTransducer.list_available_models()]
    pm = _port_model("ctc", "char")
    name = "stt_en_conformer_ctc_small"
    cache, env_cache = tmp_path / "cache", tmp_path / "env"
    cache.mkdir()
    env_cache.mkdir()
    pm.save_portable(str(cache / f"{name}.cntpu"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("CONFORMER_NEMO_TPU_CACHE", raising=False)
    with pytest.raises(FileNotFoundError, match="is a known model name"):
        ConformerCTC.from_pretrained(name, device="cpu")
    model = ConformerCTC.from_pretrained(name, cache_dir=str(cache), dtype=torch.float32,
                                         device="cpu")
    assert all(torch.equal(v, pm.state_dict()[k]) for k, v in model.state_dict().items())
    os.replace(cache / f"{name}.cntpu", env_cache / f"{name}.cntpu")
    monkeypatch.setenv("CONFORMER_NEMO_TPU_CACHE", str(env_cache))
    assert pretrained.resolve_pretrained(name) == str(env_cache / f"{name}.cntpu")
    model = ConformerCTC.from_pretrained(name, dtype=torch.float32, device="cpu")
    assert model.transcribe(WAVS[:1]) == pm.transcribe(WAVS[:1])
    with pytest.raises(FileNotFoundError, match="not a registered name"):
        ConformerCTC.from_pretrained("no_such_model", device="cpu")
