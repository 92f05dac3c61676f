"""The port's data pipeline against the JAX package's, on the CPU.

- BucketedLoader over a FLAC + WAV manifest with `lang` fields and an
  aggregate tokenizer: batches equal the JAX loader's (exactly) for each
  transport (f32 | pcm16 | mulaw8), with silence trimming, bos/eos, and a
  waveform augmentor drawing per-item streams; the same batches for
  num_workers 0 and 3;
- the integer batches' log-mel features against JAX `log_mel_spectrogram`
  on the same int16 and int8 arrays (within 1e-3, as tests/test_torch_features.py);
- tarred shards: brace expansion, and TarredBatchIterator's batches equal
  the JAX package's (shuffle ring included); more than one process raises,
  naming ROADMAP.md's item;
- device_prefetch keeps the loader's order and contents (the CPU path;
  tests/test_torch_prefetch_gpu.py holds the CUDA path on the card), and
  hands the loader's error to the consumer.
"""

import json
import os
import tarfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.audio import features as jf
from conformer_nemo_tpu.audio import perturb as jax_pt
from conformer_nemo_tpu.data import dataset as jds
from conformer_nemo_tpu.data import manifest as jman
from conformer_nemo_tpu.data import tarred as jtar
from conformer_nemo_tpu.data import tokenizers as jtok
from conformer_nemo_tpu_torch.audio import features as pf
from conformer_nemo_tpu_torch.audio import perturb as port_pt
from conformer_nemo_tpu_torch.data import dataset as pds
from conformer_nemo_tpu_torch.data import manifest as pman
from conformer_nemo_tpu_torch.data import tarred as ptar
from conformer_nemo_tpu_torch.data import tokenizers as ptok
from conformer_nemo_tpu_torch.data.audio_io import write_wav
from conformer_nemo_tpu_torch.data.flac_encode import write_flac
from conformer_nemo_tpu_torch.data.prefetch import device_prefetch

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
AGG = {"type": "agg", "langs": {"en": {"model_file": os.path.join(FIXTURES,
                                                                   "sp_bpe_bytefallback.model")},
                                "es": {"model_file": os.path.join(FIXTURES, "sp_unigram.model")}}}
TEXTS = [("hello world", "en"), ("hola mundo", "es"), ("the quick brown fox", "en"),
         ("el perro come", "es"), ("speech", "en"), ("una prueba larga de texto", "es"),
         ("a test", "en"), ("buenos días", "es"), ("conformer", "en")]
AUG = {"speed": {"prob": 0.5}, "gain": {"prob": 0.5}, "white_noise": {"prob": 1.0}}
FEATURE_ATOL = 1e-3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Nine clips (FLAC and WAV, leading and trailing silence) with `lang`."""
    d = tmp_path_factory.mktemp("pipe")
    rng = np.random.RandomState(0)
    with open(d / "m.json", "w", encoding="utf-8") as f:
        for i, (text, lang) in enumerate(TEXTS):
            n = int(rng.uniform(0.4, 1.2) * 16000)
            x = np.zeros(n + 6000, np.float32)
            x[3000: 3000 + n] = 0.2 * rng.randn(n)
            path = d / (f"{i}.flac" if i % 2 == 0 else f"{i}.wav")
            (write_flac if i % 2 == 0 else write_wav)(str(path), x)
            f.write(json.dumps({"audio_filepath": path.name, "duration": len(x) / 16000,
                                "text": text, "lang": lang}) + "\n")
    return str(d / "m.json")


def _loaders(manifest, transport, num_workers=0, trim=False, aug=False, bos=False):
    def build(ds_mod, man_mod, tok_mod, pt_mod):
        tok = tok_mod.build_tokenizer(AGG)
        if bos:
            tok.bos_id, tok.eos_id = 581, 582
        ds = ds_mod.BucketedAudioTextDataset(
            man_mod.read_manifest(manifest), tok, n_buckets=2, trim_silence=trim,
            use_start_end_token=bos, augmentor=pt_mod.process_augmentations(AUG) if aug else None)
        return ds_mod.BucketedLoader(ds, 3, shuffle=True, seed=5, num_workers=num_workers,
                                     transport=transport)

    return build(pds, pman, ptok, port_pt), build(jds, jman, jtok, jax_pt)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.audio.dtype == b.audio.dtype
        for k in ("audio", "audio_lens", "tokens", "token_lens"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
        assert a.texts == b.texts


@pytest.mark.parametrize("transport,trim,aug,bos", [
    ("f32", False, False, False), ("pcm16", False, False, False),
    ("mulaw8", False, False, False), ("f32", True, False, True), ("pcm16", False, True, False),
    ("mulaw8", True, True, False)])
def test_loader_batches_match_jax(corpus, transport, trim, aug, bos):
    port, ref = _loaders(corpus, transport, trim=trim, aug=aug, bos=bos)
    for _ in range(2):  # two epochs: the augmentation streams follow the epoch
        got, want = list(port), list(ref)
        _assert_batches_equal(got, want)
    assert got[0].audio.dtype == {"f32": np.float32, "pcm16": np.int16,
                                  "mulaw8": np.int8}[transport]
    # the manifest's lang picked each row's language: ids past es's offset
    langs = dict(TEXTS)
    for b in got:
        for row, text in enumerate(b.texts):
            if text:
                toks = b.tokens[row, int(bos): b.token_lens[row] - int(bos)]
                assert (toks >= 295).all() == (langs[text] == "es"), text
    threaded, _ = _loaders(corpus, transport, num_workers=3, trim=trim, aug=aug, bos=bos)
    first, _ = _loaders(corpus, transport, trim=trim, aug=aug, bos=bos)
    _assert_batches_equal(list(threaded), list(first))


def test_unknown_transport_raises(corpus):
    port, _ = _loaders(corpus, "f32")
    with pytest.raises(ValueError, match="unknown transport 'f16'"):
        pds.BucketedLoader(port.ds, 3, transport="f16")


@pytest.mark.parametrize("transport", ["pcm16", "mulaw8"])
def test_integer_batches_give_jax_features(corpus, transport):
    port, _ = _loaders(corpus, transport)
    cfg_p, cfg_j = pf.MelFeatureConfig(dither=0.0), jf.MelFeatureConfig(dither=0.0)
    for b in port:
        mel_j, len_j = jf.log_mel_spectrogram(cfg_j, jnp.asarray(b.audio),
                                              jnp.asarray(b.audio_lens))
        mel_p, len_p = pf.log_mel_spectrogram(cfg_p, torch.from_numpy(b.audio),
                                              torch.from_numpy(b.audio_lens))
        np.testing.assert_array_equal(len_p.numpy(), np.asarray(len_j))
        valid = np.arange(mel_p.shape[-1])[None, None, :] < len_p.numpy()[:, None, None]
        np.testing.assert_allclose(np.where(valid, mel_p.numpy(), 0),
                                   np.where(valid, np.asarray(mel_j), 0), rtol=0,
                                   atol=FEATURE_ATOL)


@pytest.fixture(scope="module")
def shards(corpus):
    d = os.path.dirname(corpus)
    with open(corpus, encoding="utf-8") as f:
        rows = [json.loads(line) for line in f]
    for s in range(3):
        with tarfile.open(os.path.join(d, f"audio_{s}.tar"), "w") as tar:
            for row in rows[s::3]:
                tar.add(os.path.join(d, row["audio_filepath"]), arcname=row["audio_filepath"])
            tar.add(corpus, arcname="not_in_manifest.json")
    return os.path.join(d, "audio_{0..2}.tar"), os.path.join(d, "audio__OP_0..2_CL_.tar")


@pytest.mark.parametrize("shuffle_n,transport", [(0, "f32"), (4, "f32"), (4, "pcm16")])
def test_tarred_batches_match_jax(corpus, shards, shuffle_n, transport):
    for pattern in shards:
        assert ptar.expand_sharded_filepaths(pattern) == jtar.expand_sharded_filepaths(pattern)
    assert ptar.expand_sharded_filepaths(f"{shards[0]},x.tar", "replicate") == \
        jtar.expand_sharded_filepaths(f"{shards[0]},x.tar", "replicate")

    def batches(tar_mod, tok_mod, **kw):
        ds = tar_mod.TarredAudioTextDataset(shards[0], corpus, tok_mod.build_tokenizer(
            {"model_file": AGG["langs"]["en"]["model_file"]}), shuffle_n=shuffle_n, seed=3)
        return list(tar_mod.TarredBatchIterator(ds, 4, max_samples_len=30000, max_tokens=24,
                                                **kw))

    got, want = batches(ptar, ptok, transport=transport), batches(jtar, jtok)
    assert len(got) == len(want) == 3 and sum(len([t for t in b.texts if t]) for b in got) == 9
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.audio_lens, b.audio_lens)
        assert a.texts == b.texts
        if transport == "f32":
            np.testing.assert_array_equal(a.audio, b.audio)
        else:  # the same float waveform, quantised as the bucketed loader's collate does
            np.testing.assert_array_equal(
                a.audio, np.clip(b.audio * 32768.0, -32768, 32767).astype(np.int16))


def test_tarred_refuses_more_than_one_process(corpus, shards):
    """Ranks share the shards as the JAX package shares them: `scatter`
    refuses a world that does not divide the shards, as the JAX package's
    does (tests/test_torch_distributed_data.py holds the rank slices
    against it index for index)."""
    for mod in (ptar, jtar):  # three shards
        with pytest.raises(ValueError, match="divisible by world_size"):
            mod.expand_sharded_filepaths(shards[0], world_size=2, global_rank=1)
    assert (ptar.expand_sharded_filepaths(shards[0], world_size=3, global_rank=1)
            == jtar.expand_sharded_filepaths(shards[0], world_size=3, global_rank=1))
    with pytest.raises(ValueError, match="divisible by world_size"):
        ptar.TarredAudioTextDataset(shards[0], corpus, None, world_size=2)
    assert (ptar.expand_sharded_filepaths(shards[0], "replicate", world_size=2, global_rank=1)
            == jtar.expand_sharded_filepaths(shards[0], "replicate", world_size=2,
                                             global_rank=1))


def test_prefetch_keeps_order_and_contents(corpus):
    port, _ = _loaders(corpus, "pcm16", num_workers=2, aug=True)
    want = list(_loaders(corpus, "pcm16", aug=True)[0])
    got = list(device_prefetch(port, "cpu"))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in ("audio", "audio_lens", "tokens", "token_lens"):
            t = getattr(a, k)
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), getattr(b, k))
        assert a.texts == b.texts
    # a consumer that stops early, then the loader's next epoch
    gen = device_prefetch(port, "cpu")
    next(gen)
    gen.close()
    assert len(list(device_prefetch(port, "cpu"))) == len(want)

    def failing():
        yield want[0]
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(device_prefetch(failing(), "cpu"))
