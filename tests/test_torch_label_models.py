"""The port's label models (api_label.py) against the JAX package's, on the
CPU: classification, regression and speaker.

For each kind, on tiny architectures: the training step's loss, every
gradient and the BatchNorm statistics after it, on the same features and
weights (the JAX step's log-mel dither cannot match streams, so both take
the same features); `fit` on a manifest; `predict` / `evaluate` and the
logits on waveforms through each package's own features; the `.cntpu`
archives both ways (the JAX package restores the port's and gives its
outputs, and the port the JAX package's); `change_labels` and
`change_se_context_window`; the speaker model's embeddings,
`verify_speakers` and `get_batch_embeddings`; the VAD frame probabilities
and `as_vad_callable`; and the two CLIs (the speaker CLI's diarize and
score modes against the library calls).

Tolerances: logits, embeddings and probabilities 1e-4 absolute (fp32 on
both sides; the two log-mel front ends agree to ~1e-6 and the encoder adds
summation-order rounding); losses 1e-5 relative, gradients 1e-4 of each
tensor's largest entry. The angular loss's scale of 30 multiplies the
cosines' fp32 rounding (~3e-6) inside exponentials, so the speaker model's
loss is held to 1e-4 and its gradients to 1e-3 (measured 7e-5 and 1.7e-4).
Labels, lengths and archives exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conformer_nemo_tpu import api_label as jal
from conformer_nemo_tpu.audio.features import MelFeatureConfig as JaxMel
from conformer_nemo_tpu.models.conv_asr import JasperBlockConfig as JaxBlock
from conformer_nemo_tpu.train.trainer import TrainState as JaxTrainState
from conformer_nemo_tpu_torch import api_label as pal
from conformer_nemo_tpu_torch.audio.features import MelFeatureConfig
from conformer_nemo_tpu_torch.convert.jax_params import (
    label_state_dict_from_jax,
    label_variables_to_jax,
)
from conformer_nemo_tpu_torch.data.audio_io import write_wav
from conformer_nemo_tpu_torch.models.conv_asr import JasperBlockConfig
from conformer_nemo_tpu_torch.scripts import speaker_tasks, speech_classification

torch.set_num_threads(2)

SR = 16000
ATOL = 1e-4
RTOL = 1e-5
ANGULAR_RTOL = 1e-4
GRAD_REL = 1e-4
ANGULAR_GRAD_REL = 1e-3
ZERO_GRAD = "'attn_proj']['bias']"
ZERO_ATOL = 1e-6
FEATS = 16


def _blocks(cls):
    return [cls(filters=16, repeat=1, kernel=5, residual=False, separable=True),
            cls(filters=16, repeat=2, kernel=7, residual=True, separable=True, se=True),
            cls(filters=16, repeat=1, kernel=1, residual=False)]


SPK_ARCH = dict(filters=(16, 16, 16, 32), kernel_sizes=(5, 3, 3, 1), dilations=(1, 2, 1, 1),
                scale=4, emb_sizes=(8,))


def _tone(f0, dur, seed):
    t = np.arange(int(dur * SR)) / SR
    rs = np.random.RandomState(seed)
    return (0.3 * np.sin(2 * np.pi * f0 * t) + 0.01 * rs.randn(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("labels")
    rows, wavs = [], []
    for i in range(6):
        label = "low" if i % 2 == 0 else "high"
        dur = 0.4 + 0.1 * (i % 3)
        path = str(root / f"u{i}.wav")
        write_wav(path, _tone(150 if label == "low" else 600, dur, i), SR)
        rows.append({"audio_filepath": path, "duration": dur, "label": label})
        wavs.append(path)
    manifest = str(root / "m.json")
    with open(manifest, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    reg = str(root / "reg.json")
    with open(reg, "w") as f:
        f.writelines(json.dumps({**r, "label": 0.5 * i}) + "\n" for i, r in enumerate(rows))
    return {"root": root, "manifest": manifest, "regression": reg, "wavs": wavs}


def _port(kind, labels=("high", "low")):
    if kind == "speaker":
        return pal.SpeakerLabelModel(list(labels), mel=MelFeatureConfig(features=FEATS),
                                     device="cpu", **SPK_ARCH)
    pcls = pal.RegressionModel if kind == "regression" else pal.ClassificationModel
    return pcls(labels=[] if kind == "regression" else list(labels),
                mel=MelFeatureConfig(features=FEATS), blocks=_blocks(JasperBlockConfig),
                device="cpu")


_SHARED = {}


def _shared(kind):
    """One pair a kind for the tests that leave both models as they were."""
    if kind not in _SHARED:
        _SHARED[kind] = _models(kind)
    return _SHARED[kind]


def _models(kind, labels=("high", "low")):
    """(JAX model with a jit-initialised state, port model on its weights)."""
    if kind == "speaker":
        jm = jal.SpeakerLabelModel(list(labels), mel=JaxMel(features=FEATS), **SPK_ARCH)
    else:
        jcls = jal.RegressionModel if kind == "regression" else jal.ClassificationModel
        jm = jcls(labels=[] if kind == "regression" else list(labels),
                  mel=JaxMel(features=FEATS), blocks=_blocks(JaxBlock))
    pm = _port(kind, labels)
    feats = jnp.zeros((1, FEATS, 64), jnp.float32)
    variables = jax.jit(lambda: jm.net.init(jax.random.PRNGKey(0), feats,
                                            jnp.full((1,), 64, jnp.int32), train=False))()
    jm.state = JaxTrainState.create(variables["params"], variables.get("batch_stats", {}),
                                    optax.adamw(1e-3).init(variables["params"]),
                                    jax.random.PRNGKey(1))
    pm.model.load_state_dict(label_state_dict_from_jax(
        jax.tree.map(np.asarray, variables), pm.model))
    return jm, pm


KINDS = ["classification", "regression", "speaker"]


@pytest.fixture(autouse=True)
def _compiled_jax_inference(monkeypatch):
    """Run the JAX models' initialisation, features and inference forward
    as compiled programs (one per model) rather than op by op: the same
    arithmetic, a fraction of this box's time."""
    cls = jal._EncDecLabelModel
    init, apply, features = cls._init_state, cls._apply, cls._features
    cache = {}

    def _init_state(self, optimizer, example_t_frames=128):
        feats = jnp.zeros((1, self.mel.features, example_t_frames), jnp.float32)
        v = jax.jit(lambda: self.net.init(jax.random.PRNGKey(0), feats,
                                          jnp.full((1,), example_t_frames, jnp.int32),
                                          train=False))()
        return JaxTrainState.create(v["params"], v.get("batch_stats", {}),
                                    optimizer.init(v["params"]), jax.random.PRNGKey(1))

    def _apply(self, state, feats, lens, train=False, rng=None):
        if train or rng is not None:
            return apply(self, state, feats, lens, train, rng)
        key = ("apply", id(self), id(self.net))
        if key not in cache:
            cache[key] = (self, jax.jit(lambda st, f, l: apply(self, st, f, l)))
        return cache[key][1](state, feats, lens)

    def _features(self, audio, lens, rng=None, training=False):
        if rng is not None or training:
            return features(self, audio, lens, rng, training)
        key = ("features", id(self))
        if key not in cache:
            cache[key] = (self, jax.jit(lambda a, l: features(self, a, l)))
        return cache[key][1](audio, lens)

    monkeypatch.setattr(cls, "_init_state", _init_state)
    monkeypatch.setattr(cls, "_apply", _apply)
    monkeypatch.setattr(cls, "_features", _features)


@pytest.fixture(scope="module", params=KINDS)
def pair(request):
    return request.param, _shared(request.param)


def _jax_logits(jm, audio, lens):
    return np.asarray(jax.jit(jm._infer_logits)(jnp.asarray(audio), jnp.asarray(lens)))


def test_train_step_matches_jax(pair):
    kind, (jm, pm) = pair
    rs = np.random.RandomState(1)
    feats = rs.randn(4, FEATS, 40).astype(np.float32)
    lens = np.array([40, 40, 31, 40], np.int32)
    labels = (np.array([0.1, 1.5, -0.3, 2.0], np.float32) if kind == "regression"
              else np.array([0, 1, 1, 0], np.int32))
    variables = {"params": jm.state.params, "batch_stats": jm.state.batch_stats}

    def jloss(params):
        out, upd = jm.net.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                jnp.asarray(feats), jnp.asarray(lens), train=True,
                                rngs={"dropout": jax.random.PRNGKey(0)},
                                mutable=["batch_stats"])
        return jm._loss(out, jnp.asarray(labels)), upd

    (want, upd), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables["params"])
    pm.model.train()
    out = pm.model(torch.from_numpy(feats), torch.from_numpy(lens))
    got = pm._loss(out, torch.from_numpy(labels))
    got.backward()
    pm.model.eval()
    rel = ANGULAR_RTOL if kind == "speaker" else RTOL
    assert float(got.detach()) == pytest.approx(float(want), rel=rel)
    tree = label_variables_to_jax({**pm.model.state_dict(),
                                   **{n: p.grad for n, p in pm.model.named_parameters()}},
                                  pm.model)
    flat_g = dict(jax.tree_util.tree_flatten_with_path(tree["params"])[0])
    grad_rel = ANGULAR_GRAD_REL if kind == "speaker" else GRAD_REL
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        g = np.asarray(g)
        err = np.abs(flat_g[path] - g).max()
        if jax.tree_util.keystr(path).endswith(ZERO_GRAD):
            assert err <= ZERO_ATOL, path
        else:
            assert err <= grad_rel * np.abs(g).max(), path
    flat_s = dict(jax.tree_util.tree_flatten_with_path(tree["batch_stats"])[0])
    for path, s in jax.tree_util.tree_flatten_with_path(upd["batch_stats"])[0]:
        np.testing.assert_allclose(flat_s[path], np.asarray(s), atol=1e-5, err_msg=str(path))
    pm.model.zero_grad(set_to_none=True)
    pm.model.load_state_dict(label_state_dict_from_jax(jax.tree.map(np.asarray, variables),
                                                       pm.model))


def test_inference_and_archives_cross_both_ways(pair, data, tmp_path):
    kind, (jm, pm) = pair
    manifest = data["regression"] if kind == "regression" else data["manifest"]
    rs = np.random.RandomState(2)
    audio = (0.2 * rs.randn(3, 8000)).astype(np.float32)
    lens = np.array([8000, 6000, 8000], np.int32)
    np.testing.assert_allclose(pm._infer_logits(audio, lens).numpy(),
                               _jax_logits(jm, audio, lens), atol=ATOL)
    # the JAX package's archive in the port, and the port's in the JAX package
    jpath, ppath = str(tmp_path / "jax.cntpu"), str(tmp_path / "port.cntpu")
    jm.save_portable(jpath)
    cls = type(pm)
    restored = cls.restore_portable(jpath, device="cpu")
    for (n, a), b in zip(pm.model.state_dict().items(), restored.model.state_dict().values()):
        assert torch.equal(a, b), n
    with torch.no_grad():
        for p in restored.model.parameters():
            p.mul_(1.01)
    restored.save_portable(ppath)
    jback = type(jm).restore_portable(ppath)
    assert jback.labels == restored.labels
    np.testing.assert_allclose(restored._infer_logits(audio, lens).numpy(),
                               _jax_logits(jback, audio, lens), atol=ATOL)
    if kind == "speaker":
        return
    top = (1,) if kind == "classification" else ()
    assert restored.evaluate(manifest, batch_size=4, fixed_seconds=0.5, top_k=top) == \
        pytest.approx(jback.evaluate(manifest, batch_size=4, fixed_seconds=0.5, top_k=top),
                      abs=1e-5)
    got = restored.predict(data["wavs"], batch_size=4, fixed_seconds=0.5)
    want = jback.predict(data["wavs"], batch_size=4, fixed_seconds=0.5)
    if kind == "classification":
        assert got == want
        np.testing.assert_allclose(
            np.stack(restored.predict(data["wavs"][:2], fixed_seconds=0.5, logprobs=True)),
            np.stack(jback.predict(data["wavs"][:2], fixed_seconds=0.5, logprobs=True)),
            atol=ATOL)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_speaker_embeddings_match_jax(data):
    jm, pm = _shared("speaker")
    wav = data["wavs"][1]
    np.testing.assert_allclose(pm.get_embedding(wav), np.asarray(jm.get_embedding(wav)),
                               atol=ATOL)
    assert (pm.verify_speakers(data["wavs"][0], data["wavs"][3], 0.6)
            == jm.verify_speakers(data["wavs"][0], data["wavs"][3], 0.6))
    got = pm.get_batch_embeddings(data["manifest"], batch_size=4, fixed_seconds=0.5)
    want = jm.get_batch_embeddings(data["manifest"], batch_size=4, fixed_seconds=0.5)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, atol=ATOL)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == want[3]


def test_vad_frame_probs_match_jax():
    jm, pm = _models("classification", labels=("background", "speech"))
    rs = np.random.RandomState(7)
    wav = np.concatenate([(0.005 * rs.randn(int(0.5 * SR))).astype(np.float32),
                          _tone(350, 0.6, 3)])
    got = pm.vad_frame_probs(wav, window_length_in_sec=0.31, shift_length_in_sec=0.02,
                             batch_size=16)
    want = jm.vad_frame_probs(wav, window_length_in_sec=0.31, shift_length_in_sec=0.02,
                              batch_size=16)
    assert got.shape == want.shape == ((len(wav) - int(0.31 * SR)) // int(0.02 * SR) + 1,)
    np.testing.assert_allclose(got, want, atol=ATOL)
    params = {"onset": 0.5, "offset": 0.45, "min_duration_on": 0.04}
    segs = pm.as_vad_callable(params, 0.31, 0.02)(wav, SR)
    from conformer_nemo_tpu_torch.decode.vad import postprocess_frame_predictions

    assert segs == postprocess_frame_predictions(got, params, shift_length_in_sec=0.02)
    with pytest.raises(ValueError, match="Hz"):
        pm.as_vad_callable()(wav, 8000)


def test_fit_change_labels_and_se_window(data):
    jm, pm = _models("classification")
    out = pm.fit(data["manifest"], data["manifest"], max_steps=2, batch_size=4,
                 fixed_seconds=0.5, augment=True, log_every_n_steps=1)
    assert out["steps"] == 2 and all(np.isfinite(h["loss"]) for h in out["history"])
    assert set(out["val"]) == {"top1"}
    assert pm.fit(data["manifest"], max_steps=3, batch_size=4, fixed_seconds=0.5)["steps"] == 3
    enc = {k: v.clone() for k, v in pm.model.encoder.state_dict().items()}
    pm.change_labels(["a", "b", "c"])
    assert pm.model.decoder.fc.out_features == 3 and pm.labels == ["a", "b", "c"]
    for k, v in pm.model.encoder.state_dict().items():
        assert torch.equal(v, enc[k]), k
    # JAX's change_labels keeps the encoder the same way
    jm.state = jm.state.replace(params={**jm.state.params, "encoder": jax.tree.map(
        jnp.asarray, label_variables_to_jax(pm.model.state_dict(), pm.model)["params"]["encoder"])})
    rs = np.random.RandomState(3)
    feats = rs.randn(2, FEATS, 30).astype(np.float32)
    lens = np.array([30, 20], np.int32)
    before = pm.model(torch.from_numpy(feats), torch.from_numpy(lens))
    pm.change_se_context_window(8)
    assert pm._blocks[1].se_context_window == 8
    after = pm.model(torch.from_numpy(feats), torch.from_numpy(lens))
    assert after.shape == before.shape and not torch.allclose(after, before)
    jm.change_labels(["a", "b", "c"])
    jm.change_se_context_window(8)
    jvars = {"params": {**jm.state.params, "decoder": jax.tree.map(
        jnp.asarray, label_variables_to_jax(pm.model.state_dict(), pm.model)["params"]["decoder"])},
        "batch_stats": jax.tree.map(jnp.asarray, label_variables_to_jax(
            pm.model.state_dict(), pm.model)["batch_stats"])}
    want = jm.net.apply(jvars, jnp.asarray(feats), jnp.asarray(lens), train=False)
    np.testing.assert_allclose(after.detach().numpy(), np.asarray(want), atol=ATOL)


def test_speaker_and_regression_fit(data):
    spk = _port("speaker")
    out = spk.fit(data["manifest"], max_steps=2, batch_size=4, fixed_seconds=0.5,
                  log_every_n_steps=1)
    assert [h["step"] for h in out["history"]] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    reg = _port("regression")
    out = reg.fit(data["regression"], data["regression"], max_steps=1, batch_size=4,
                  fixed_seconds=0.5)
    assert set(out["val"]) == {"mse", "mae"} and np.isfinite(out["history"][-1]["mse"])


def test_restore_refuses_another_kind(data, tmp_path):
    pm = _port("classification")
    path = str(tmp_path / "c.cntpu")
    pm.save_portable(path)
    with pytest.raises(ValueError, match="classification"):
        pal.SpeakerLabelModel.restore_portable(path, device="cpu")


def test_clis(data, tmp_path, capsys):
    model_path = str(tmp_path / "cls.cntpu")
    args = ["--train-manifest", data["manifest"], "--max-steps", "1", "--batch-size", "4",
            "--fixed-seconds", "0.5", "--features", str(FEATS), "--out", model_path,
            "--device", "cpu"]
    model, result, _ = speech_classification.main(args)
    assert result["steps"] == 1 and model.labels == ["high", "low"]
    _, _, preds = speech_classification.main(["--model", model_path, "--predict",
                                              *data["wavs"][:3], "--fixed-seconds", "0.5",
                                              "--device", "cpu"])
    assert preds == model.predict(data["wavs"][:3], fixed_seconds=0.5)
    spk_path = str(tmp_path / "spk.cntpu")
    spk, result = speaker_tasks.main(["train", "--train-manifest", data["manifest"],
                                      "--max-steps", "1", "--batch-size", "4",
                                      "--fixed-seconds", "0.5", "--features", str(FEATS),
                                      "--out", spk_path, "--device", "cpu"])
    assert result["steps"] == 1
    _, same = speaker_tasks.main(["verify", "--model", spk_path, *data["wavs"][:2],
                                  "--device", "cpu"])
    assert same == spk.verify_speakers(*data["wavs"][:2])
    _, embs = speaker_tasks.main(["embed", "--model", spk_path, data["wavs"][0],
                                  "--device", "cpu"])
    np.testing.assert_array_equal(embs[data["wavs"][0]], spk.get_embedding(data["wavs"][0]))
    # diarize and score through the CLI, against the library calls
    from conformer_nemo_tpu_torch.data.audio_io import load_audio
    from conformer_nemo_tpu_torch.decode.der import score_rttm_files, write_rttm
    from conformer_nemo_tpu_torch.decode.diarization import ClusteringDiarizer, to_rttm

    session = str(tmp_path / "session.wav")
    write_wav(session, np.concatenate([load_audio(p) for p in data["wavs"][:4]]), SR)
    args = ["--model", spk_path, session, "--num-speakers", "2", "--window", "0.5", "--shift",
            "0.25", "--device", "cpu"]
    _, rttm = speaker_tasks.main(["diarize", *args])
    turns = ClusteringDiarizer(spk, window=0.5, shift=0.25).diarize(session,
                                                                     oracle_num_speakers=2)
    assert rttm == to_rttm(turns, "session") and rttm.count("SPEAKER") == len(turns) > 0
    out_path = str(tmp_path / "hyp.rttm")
    _, again = speaker_tasks.main(["diarize", *args, "--rttm-out", out_path])
    assert again == rttm and open(out_path).read() == rttm
    ref = write_rttm(str(tmp_path / "ref.rttm"), [(0.0, 0.9, "low"), (0.9, 1.9, "high")],
                     "session")
    model, score = speaker_tasks.main(["score", "--ref-rttm", ref, "--hyp-rttm", out_path,
                                       "--collar", "0.1"])
    want = score_rttm_files([(ref, out_path)], collar=0.1, ignore_overlap=True)
    assert model is None and score == {k: round(v, 4) for k, v in want.items()}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == score
