"""`change_vocabulary` of both model families, on the CPU, against the JAX
package (fp32, tiny: 2 layers, d_model 64; the transducer's prediction and
joint width 32):

- the JAX model's archive restored in the port, then both packages change
  from the 295-piece fixture tokenizer to the 288-piece unigram one;
- the port keeps its encoder bit for bit (parameters and BatchNorm
  statistics), makes the head at the new size (CTC V+1 289; the
  transducer's embedding and joint output 289 rows) and drops its
  optimizer state and cached decoders;
- the two packages draw their new heads from different generators, so the
  JAX model's new head is bridged into the port (`ctc_state_dict_from_jax`
  / `rnnt_state_dict_from_jax`): then the same texts and log-probs (CTC)
  or joint outputs (transducer) within 1e-4. The JAX package's
  change_vocabulary keeps the encoder's parameters but starts its
  BatchNorm statistics anew (its new train state's); NeMo and the port
  keep them, so the JAX model gets its statistics back before the
  comparison;
- one `fit` step on the new vocabulary: a finite loss, the new head and
  the encoder trained.
"""

import json
import os

import numpy as np
import pytest
import torch

from conformer_nemo_tpu.data.tokenizers import SentencePieceTokenizer as JaxSP
from conformer_nemo_tpu_torch.api import ConformerCTC, ConformerTransducer
from conformer_nemo_tpu_torch.convert.jax_params import (
    ctc_state_dict_from_jax,
    rnnt_state_dict_from_jax,
)
from conformer_nemo_tpu_torch.data.audio_io import write_wav
from conformer_nemo_tpu_torch.data.tokenizers import SentencePieceTokenizer

from test_torch_portable import ARTIFACTS, FIXTURES, _assert_same_outputs, _jax_model

torch.set_num_threads(2)

NEW_SP = os.path.join(FIXTURES, "sp_unigram.model")
HEADS = {"ctc": ("decoder.",), "rnnt": ("decoder.", "joint.")}


def _variables(jm) -> dict:
    out = {"params": jm.state.params}
    if jm.state.batch_stats:
        out["batch_stats"] = jm.state.batch_stats
    return out


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    d = tmp_path_factory.mktemp("new_vocab")
    rng = np.random.RandomState(2)
    with open(d / "train.json", "w", encoding="utf-8") as f:
        for i, text in enumerate(["hola mundo", "buenos dias"]):
            n = int(rng.uniform(1.0, 1.5) * 16000)
            write_wav(str(d / f"{i}.wav"), (0.1 * rng.randn(n)).astype(np.float32))
            f.write(json.dumps({"audio_filepath": f"{i}.wav", "duration": n / 16000,
                                "text": text}) + "\n")
    return str(d / "train.json")


@pytest.mark.parametrize("kind", ["ctc", "rnnt"])
def test_change_vocabulary_matches_jax(kind, tmp_path):
    cls = ConformerCTC if kind == "ctc" else ConformerTransducer
    jm = _jax_model(kind, "bpe", seed=5)
    path = str(tmp_path / "m.cntpu")
    jm.save_portable(path, artifacts=ARTIFACTS)
    pm = cls.restore_portable(path, dtype=torch.float32, device="cpu")
    pm.train_state = pm._init_state(pm._make_optimizer())  # an optimizer state to drop
    enc_before = {k: v.clone() for k, v in pm.model.encoder.state_dict().items()}
    old_decoding = getattr(pm, "decoding", None)

    stats = jm.state.batch_stats
    jm.change_vocabulary(JaxSP(NEW_SP))
    assert not np.array_equal(  # the JAX package's statistics start anew
        np.asarray(jm.state.batch_stats["encoder"]["layers_0"]["conv"]["norm"]["mean"]),
        np.asarray(stats["encoder"]["layers_0"]["conv"]["norm"]["mean"]))
    jm.state = jm.state.replace(batch_stats=stats)
    pm.change_vocabulary(SentencePieceTokenizer(NEW_SP))
    v1 = pm.tokenizer.vocab_size + 1
    assert v1 == 289 and pm.train_state is None
    enc_after = pm.model.encoder.state_dict()
    assert enc_after.keys() == enc_before.keys()
    assert all(torch.equal(enc_before[k], enc_after[k]) for k in enc_before)
    if kind == "ctc":
        assert pm.model.decoder.decoder_layers[0].weight.shape == (289, 64, 1)
        assert pm.cfg.num_classes == 288 and pm._beam_decoder is None
    else:
        assert pm.model.decoder.prediction.embed.weight.shape == (289, 32)
        assert pm.model.joint.out.weight.shape == (289, 32)
        assert pm.cfg.model.decoder.vocab_size == 288
        assert pm.decoding is not old_decoding and pm.decoding.model is pm.model

    bridge = ctc_state_dict_from_jax if kind == "ctc" else rnnt_state_dict_from_jax
    bridged = bridge(_variables(jm), pm.cfg if kind == "ctc" else pm.cfg.model)
    for k, v in bridged.items():
        if k.startswith("encoder."):
            assert torch.equal(v, enc_after[k[len("encoder."):]]), k
    head = {k: v for k, v in bridged.items() if k.startswith(HEADS[kind])}
    missing, unexpected = pm.model.load_state_dict(head, strict=False)
    assert not unexpected and all(k.startswith("encoder.") for k in missing)
    _assert_same_outputs(kind, jm, pm)


@pytest.mark.parametrize("kind", ["ctc", "rnnt"])
def test_one_fit_step_on_the_new_vocabulary(kind, manifest, tmp_path):
    cls = ConformerCTC if kind == "ctc" else ConformerTransducer
    jm = _jax_model(kind, "bpe", seed=7)
    path = str(tmp_path / "m.cntpu")
    jm.save_portable(path, artifacts=ARTIFACTS)
    pm = cls.restore_portable(path, dtype=torch.float32, device="cpu")
    pm.change_vocabulary(SentencePieceTokenizer(NEW_SP))
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    out = pm.fit(manifest, max_steps=1)
    assert out["steps"] == 1 and np.isfinite(out["last_loss"])
    after = pm.state_dict()
    head = "decoder.decoder_layers.0.weight" if kind == "ctc" else "joint.joint_net.2.weight"
    assert after[head].shape[0] == 289 and not torch.equal(before[head], after[head])
    assert not torch.equal(before["encoder.layers.1.self_attn.linear_q.weight"],
                           after["encoder.layers.1.self_attn.linear_q.weight"])
    assert isinstance(pm.transcribe([os.path.join(os.path.dirname(manifest), "0.wav")])[0], str)
