"""`.nemo` loading (convert/nemo_archive.py, convert/nemo_state.py,
scripts/convert_nemo.py), on the CPU, against the JAX package's
scripts/convert_nemo.py on the same files. The test writes its own NeMo
checkpoints from the port's models (whose state_dicts carry NeMo's names),
with what NeMo adds: BatchNorm's num_batches_tracked, the preprocessor's
featurizer buffers, `_target_` keys and a custom YAML tag in the config,
the tokenizer under an md5-mangled name.

- a CTC BPE `.nemo` (fixture SentencePiece), a char transducer `.nemo` with
  joint dropout (its output Linear `joint.joint_net.2`) and without
  (`joint_net.1`), a Lightning `.ckpt` ({"state_dict": {"model.*"}, and
  non-tensor entries}) with `--config`, and an aggregate (`agg`) archive
  with per-language models registered as `model_path: nemo:<md5>_tokenizer.model`;
- the JAX converter and the port's `convert` (and `main`) on each file:
  their two `.cntpu` restore to the same parameters in both packages (the
  LSTM forget chunk within one ulp), the port's restore equals the source
  model (texts equal, CTC log-probs within 1e-4) and its tokenizer is the
  source's;
- a vggnet `.nemo` (a non-striding front end, once refused) loads in both.
"""

import hashlib
import importlib.util
import os
import shutil
import tarfile

import jax
import numpy as np
import pytest
import torch
import yaml

from conformer_nemo_tpu.api import ConformerCTC as JaxConformerCTC
from conformer_nemo_tpu.api import ConformerTransducer as JaxConformerTransducer
from conformer_nemo_tpu_torch.api import ConformerCTC, ConformerTransducer
from conformer_nemo_tpu_torch.convert.nemo_archive import load_nemo_archive, load_torch_weights
from conformer_nemo_tpu_torch.scripts import convert_nemo

from test_torch_portable import ATOL, CASES, ENC, FIXTURES, ROOT, SP_MODEL, WAVS, _port_model

torch.set_num_threads(2)

ES_MODEL = os.path.join(FIXTURES, "sp_unigram.model")


def _jax_convert():
    """The JAX package's scripts/convert_nemo.py `convert`."""
    spec = importlib.util.spec_from_file_location(
        "jax_convert_nemo", os.path.join(ROOT, "scripts", "convert_nemo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.convert


def _mangled(src: str) -> str:
    """The name NeMo stores a tokenizer model under: <md5>_tokenizer.model."""
    with open(src, "rb") as f:
        return hashlib.md5(f.read()).hexdigest() + "_tokenizer.model"


def _nemo_state(pm, joint_index: int = 2) -> dict:
    """The port model's state_dict as NeMo saves it."""
    sd = {}
    for k, v in pm.state_dict().items():
        if k.startswith("joint.joint_net.2."):
            k = k.replace("joint_net.2.", f"joint_net.{joint_index}.")
        sd[k] = v.clone()
        if k.endswith("batch_norm.running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(17)
    sd["preprocessor.featurizer.fb"] = torch.rand(1, 80, 257)
    sd["preprocessor.featurizer.window"] = torch.hann_window(400)
    return sd


def _nemo_config(pm, tokenizer=None) -> dict:
    m = {k: v for k, v in pm.raw_cfg["model"].items()
         if k not in ("tokenizer", "train_ds", "validation_ds", "test_ds")}
    m["train_ds"] = {"manifest_filepath": None, "batch_size": 4}
    m["preprocessor"] = {"_target_": "nemo.collections.asr.modules."
                         "AudioToMelSpectrogramPreprocessor", **m["preprocessor"]}
    m["encoder"] = {"_target_": "nemo.collections.asr.modules.ConformerEncoder", **m["encoder"]}
    if tokenizer is not None:
        m["tokenizer"] = tokenizer
    return m


def _write_nemo(path: str, m: dict, sd: dict, artifacts=()) -> str:
    work = path + ".d"
    os.makedirs(work)
    text = yaml.safe_dump(m)
    # OmegaConf may write tags of its own: the reader maps them to plain data
    text += "target_info: !omegaconf_node {kind: test}\n"
    with open(os.path.join(work, "model_config.yaml"), "w") as f:
        f.write(text)
    torch.save(sd, os.path.join(work, "model_weights.ckpt"))
    for src, member in artifacts:
        shutil.copy(src, os.path.join(work, member))
    with tarfile.open(path, "w:gz") as tar:
        for name in os.listdir(work):
            tar.add(os.path.join(work, name), arcname=name)
    return path


def _bpe_tokenizer_cfg() -> tuple:
    member = _mangled(SP_MODEL)
    return ({"dir": "/nemo/run/tokenizer", "type": "bpe", "model_path": f"nemo:{member}"},
            [(SP_MODEL, member)])


def _source(kind: str, tok: str, joint_dropout: float = 0.1):
    if kind == "rnnt":
        pm = _port_model("rnnt", tok, seed=11)
        if joint_dropout == 0.0:
            pm.raw_cfg["model"]["joint"]["jointnet"]["dropout"] = 0.0
        return pm
    return _port_model("ctc", tok, seed=12)


def _restored_equal(a, b, forget_ulps: bool) -> None:
    """Two port models' state_dicts: bit for bit, but the LSTM forget chunk
    within one ulp where an archive carried it as b - c."""
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        if forget_ulps and ".dec_rnn.lstm.bias_ih_l" in k:
            h = a.cfg.model.decoder.pred_hidden
            c = float(a.cfg.model.decoder.forget_gate_bias)
            rest = torch.ones_like(sa[k], dtype=torch.bool)
            rest[h: 2 * h] = False
            assert torch.equal(sa[k][rest], sb[k][rest]), k
            ulp = torch.finfo(torch.float32).eps * torch.maximum(sa[k][h: 2 * h].abs(),
                                                                 (sa[k][h: 2 * h] - c).abs())
            assert ((sa[k][h: 2 * h] - sb[k][h: 2 * h]).abs() <= ulp).all(), k
        else:
            assert torch.equal(sa[k], sb[k]), k


def _jax_params_equal(path_a: str, path_b: str, cls) -> None:
    """The JAX package's restores of two archives: the same tree, leaf for
    leaf (the LSTM bias within one ulp)."""
    ja, jb = (cls.restore_portable(p, dtype=jax.numpy.float32) for p in (path_a, path_b))
    la = jax.tree_util.tree_leaves_with_path({"p": ja.state.params, "s": ja.state.batch_stats})
    lb = jax.tree_util.tree_leaves_with_path({"p": jb.state.params, "s": jb.state.batch_stats})
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        if "lstm0_b" in jax.tree_util.keystr(path):
            assert np.all(np.abs(x - y) <= np.finfo(np.float32).eps * np.abs(x).clip(1.0))
        else:
            assert np.array_equal(x, y), jax.tree_util.keystr(path)


def _check_both(kind: str, pm, nemo: str, tmp_path, config=None) -> tuple:
    cls, jcls = ((ConformerCTC, JaxConformerCTC) if kind == "ctc"
                 else (ConformerTransducer, JaxConformerTransducer))
    out_p, out_j = str(tmp_path / "port.cntpu"), str(tmp_path / "jax.cntpu")
    assert convert_nemo.convert(nemo, out_p, config, device="cpu") == kind
    assert _jax_convert()(nemo, out_j, config) == kind
    from_p = cls.restore_portable(out_p, dtype=torch.float32, device="cpu")
    from_j = cls.restore_portable(out_j, dtype=torch.float32, device="cpu")
    _restored_equal(from_p, from_j, forget_ulps=False)
    _restored_equal(pm, from_p, forget_ulps=kind == "rnnt")
    _jax_params_equal(out_p, out_j, jcls)
    texts = pm.transcribe(WAVS, batch_size=2)
    assert from_p.transcribe(WAVS, batch_size=2) == texts
    if kind == "ctc":
        for a, b in zip(pm.transcribe(WAVS, logprobs=True), from_p.transcribe(WAVS, logprobs=True)):
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    return from_p, out_p


def test_archive_reader_unmangles_and_drops_what_torch_has_no_tensor_for(tmp_path):
    pm = _source("ctc", "bpe")
    tok_cfg, arts = _bpe_tokenizer_cfg()
    nemo = _write_nemo(str(tmp_path / "ctc.nemo"), _nemo_config(pm, tok_cfg), _nemo_state(pm),
                       arts)
    config, state, artifacts = load_nemo_archive(nemo, str(tmp_path / "x"))
    assert config["target_info"] == {"kind": "test"}
    assert config["encoder"]["_target_"].endswith("ConformerEncoder")
    assert os.path.basename(artifacts["tokenizer.model"]) == arts[0][1]
    assert "preprocessor.featurizer.fb" in state and all(
        isinstance(v, torch.Tensor) for v in state.values())


def test_ctc_bpe_nemo(tmp_path):
    pm = _source("ctc", "bpe")
    tok_cfg, arts = _bpe_tokenizer_cfg()
    nemo = _write_nemo(str(tmp_path / "ctc.nemo"), _nemo_config(pm, tok_cfg), _nemo_state(pm),
                       arts)
    restored, out = _check_both("ctc", pm, nemo, tmp_path)
    assert restored.tokenizer.vocab_size == pm.tokenizer.vocab_size == 295
    with tarfile.open(out) as tar:
        assert "tokenizer.model" in tar.getnames()


@pytest.mark.parametrize("joint_dropout,index", [(0.1, 2), (0.0, 1)])
def test_char_transducer_nemo(joint_dropout, index, tmp_path, capsys):
    pm = _source("rnnt", "char", joint_dropout)
    sd = _nemo_state(pm, joint_index=index)
    assert f"joint.joint_net.{index}.weight" in sd and "decoder.prediction.dec_rnn.lstm." \
        "bias_hh_l0" in sd
    nemo = _write_nemo(str(tmp_path / "rnnt.nemo"), _nemo_config(pm), sd)
    out = str(tmp_path / "main.cntpu")
    assert convert_nemo.main([nemo, out, "--device", "cpu"]) == "rnnt"
    said = capsys.readouterr().out
    assert "num_batches_tracked" in said and f"-> {out}" in said
    _check_both("rnnt", pm, nemo, tmp_path)


def test_lightning_checkpoint_with_config(tmp_path):
    pm = _source("ctc", "char")
    ckpt = str(tmp_path / "last.ckpt")
    torch.save({"epoch": 3, "global_step": 1200, "hyper_parameters": {"lr": 0.5},
                "state_dict": {"model." + k: v for k, v in _nemo_state(pm).items()}}, ckpt)
    cfg = str(tmp_path / "model_config.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump({"name": "run", "model": _nemo_config(pm)}, f)
    sd = load_torch_weights(ckpt)
    assert "encoder.pre_encode.out.weight" in sd and "epoch" not in sd
    _check_both("ctc", pm, ckpt, tmp_path, config=cfg)


def test_aggregate_tokenizer_nemo(tmp_path):
    pm = ConformerCTC.from_config_file(
        os.path.join(ROOT, "configs", "conformer_ctc_bpe_multilang.yaml"),
        overrides={**ENC, "model.tokenizer.langs.en.model_file": SP_MODEL,
                   "model.tokenizer.langs.es.model_file": ES_MODEL},
        device="cpu", dtype=torch.float32, seed=13)
    langs, arts = {}, []
    for lang, src in (("en", SP_MODEL), ("es", ES_MODEL)):
        arts.append((src, _mangled(src)))
        langs[lang] = {"type": "bpe", "dir": f"tok_{lang}", "model_path": f"nemo:{arts[-1][1]}"}
    nemo = _write_nemo(str(tmp_path / "agg.nemo"),
                       _nemo_config(pm, {"type": "agg", "langs": langs}), _nemo_state(pm), arts)
    restored, out = _check_both("ctc", pm, nemo, tmp_path)
    assert restored.tokenizer.vocab_size == pm.tokenizer.vocab_size == 583
    for lang in ("en", "es"):
        assert restored.tokenizer.text_to_ids("hola mundo", lang) == pm.tokenizer.text_to_ids(
            "hola mundo", lang)
    with tarfile.open(out) as tar:
        assert {"tokenizer_en.model", "tokenizer_es.model"} <= set(tar.getnames())
    langs["es"]["type"] = "wpe"
    bad = _write_nemo(str(tmp_path / "wpe.nemo"),
                      _nemo_config(pm, {"type": "agg", "langs": langs}), _nemo_state(pm), arts)
    with pytest.raises(NotImplementedError, match="sub-tokenizer type 'wpe'"):
        convert_nemo.convert(bad, str(tmp_path / "wpe.cntpu"), device="cpu")


def test_non_striding_subsampling_raises(tmp_path):
    """Once refused: a vggnet `.nemo` (the front end's convolutions at
    `pre_encode.conv.{5j}` and `{5j+2}`) now converts in the port as in the
    JAX package, and the restore transcribes as the source model."""
    name, overrides = CASES[("ctc", "char")]
    pm = ConformerCTC.from_config_file(
        os.path.join(ROOT, "configs", name), device="cpu", dtype=torch.float32, seed=12,
        overrides={**overrides, "model.encoder.subsampling": "vggnet",
                   "model.encoder.subsampling_conv_channels": 8})
    gen = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for p in pm.model.parameters():
            p.add_(0.2 * torch.randn(p.shape, generator=gen))
    sd = _nemo_state(pm)
    assert "encoder.pre_encode.conv.7.weight" in sd  # the second repetition's second conv
    nemo = _write_nemo(str(tmp_path / "vgg.nemo"), _nemo_config(pm), sd)
    restored, _ = _check_both("ctc", pm, nemo, tmp_path)
    assert restored.cfg.encoder.subsampling == "vggnet"
