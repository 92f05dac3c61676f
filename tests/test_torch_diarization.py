"""The port's diarization (decode/diarization.py) against the JAX package's,
on the CPU.

The NME-SC clustering is the JAX package's host numpy in float64 in both
packages, so every function is held equal, not close: the affinity, its
top-p graph, connectivity, the Laplacian and its eigengap count, the
p-value search, the seeded k-means, the spectral clustering, the anchor
count, and the labels on seeded Gaussian clusters (with an oracle count,
with the count estimated by NME-SC past 80 rows and by the anchor path
below it, and past 300 rows, where NME-SC subsamples). The pipeline's host
pieces (the energy VAD, the windows, the merge, the RTTM text) likewise.

`ClusteringDiarizer` on a tiny speaker model (the JAX model's initial
weights, bridged by `label_state_dict_from_jax`) over a two-voice session:
the window embeddings within 1e-4 (the label models' tolerance: fp32 on
both sides), and the turns equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conformer_nemo_tpu import api_label as jal
from conformer_nemo_tpu.audio.features import MelFeatureConfig as JaxMel
from conformer_nemo_tpu.data.audio_io import load_audio as jload
from conformer_nemo_tpu.data.audio_to_label import repeat_to_length as jrepeat
from conformer_nemo_tpu.decode import diarization as jd
from conformer_nemo_tpu.train.trainer import TrainState as JaxTrainState
from conformer_nemo_tpu_torch import api_label as pal
from conformer_nemo_tpu_torch.audio.features import MelFeatureConfig
from conformer_nemo_tpu_torch.convert.jax_params import label_state_dict_from_jax
from conformer_nemo_tpu_torch.data.audio_io import write_wav
from conformer_nemo_tpu_torch.decode import diarization as pd

torch.set_num_threads(2)

SR = 16000
EMB_ATOL = 1e-4
FEATS = 16
SPK_ARCH = dict(filters=(16, 16, 16, 32), kernel_sizes=(5, 3, 3, 1), dilations=(1, 2, 1, 1),
                scale=4, emb_sizes=(8,))


def _clusters(k, n_per, dim=16, sep=6.0, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(k, dim) * sep
    return np.vstack([centers[i] + rs.randn(n_per, dim) for i in range(k)])


def test_graph_helpers_equal_jax():
    emb = _clusters(3, 15, seed=4)
    mat = pd.cos_affinity_matrix(emb)
    np.testing.assert_array_equal(mat, jd.cos_affinity_matrix(emb))
    for p in (1, 3, 16):
        np.testing.assert_array_equal(pd.binarize_top_p(mat, p), jd.binarize_top_p(mat, p))
        g = pd.affinity_graph(mat, p)
        np.testing.assert_array_equal(g, jd.affinity_graph(mat, p))
        assert pd.is_fully_connected(g) == jd.is_fully_connected(g)
        np.testing.assert_array_equal(pd.laplacian(g), jd.laplacian(g))
        got, want = pd.estimate_num_speakers(g, 8), jd.estimate_num_speakers(g, 8)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    assert pd.is_fully_connected(pd.affinity_graph(mat, 16))
    assert not pd.is_fully_connected(pd.affinity_graph(mat, 1))


@pytest.mark.parametrize("kwargs", [{}, {"sparse_search": False}, {"fixed_thres": 0.2},
                                    {"nme_mat_size": 20}], ids=["sparse", "dense", "fixed",
                                                                 "subsampled"])
def test_nmesc_search_equals_jax(kwargs):
    emb = _clusters(3, 20, seed=5)
    mat = pd.cos_affinity_matrix(emb)
    assert pd.NMESC(mat, **kwargs).analyze() == jd.NMESC(mat, **kwargs).analyze()


def test_kmeans_spectral_and_anchor_count_equal_jax():
    emb = _clusters(3, 12, seed=6)
    x = np.random.RandomState(1).randn(40, 3)
    for k, seed in ((2, 0), (3, 1), (4, 2)):
        np.testing.assert_array_equal(pd._kmeans(x, k, seed=seed), jd._kmeans(x, k, seed=seed))
    g = pd.affinity_graph(pd.cos_affinity_matrix(emb), 6)
    np.testing.assert_array_equal(pd.spectral_cluster(g, 3), jd.spectral_cluster(g, 3))
    assert pd._enhanced_speaker_count(emb) == jd._enhanced_speaker_count(emb)


CLUSTER_CASES = {
    "oracle_k3": (3, 25, 1, {"oracle_num_speakers": 3}),
    # 75 rows: the anchor-embedding count (which over-counts these clusters
    # in both packages)
    "anchor_count_k3": (3, 25, 1, {}),
    "nmesc_count_k2": (2, 50, 2, {}),  # 100 rows: NME-SC's own count
    "subsampled_k3": (3, 110, 3, {}),  # 330 rows: NME-SC on a subsample
    "few_rows": (2, 3, 4, {}),  # 6 rows: no NME-SC
}


@pytest.mark.parametrize("case", list(CLUSTER_CASES))
def test_labels_equal_jax_on_gaussian_clusters(case):
    k, n_per, seed, kwargs = CLUSTER_CASES[case]
    emb = _clusters(k, n_per, seed=seed)
    got = pd.nme_spectral_clustering(emb, **kwargs)
    np.testing.assert_array_equal(got, jd.nme_spectral_clustering(emb, **kwargs))
    if case != "anchor_count_k3" and case != "few_rows":  # recovered, up to a permutation
        truth = np.repeat(np.arange(k), n_per)
        assert len(set(zip(got.tolist(), truth.tolist()))) == k
    assert pd.nme_spectral_clustering(emb[:1]).tolist() == [0]


def test_pipeline_host_pieces_equal_jax():
    rs = np.random.RandomState(2)
    wav = (0.001 * rs.randn(6 * SR)).astype(np.float32)
    t = np.arange(SR) / SR
    wav[SR: 2 * SR] += 0.5 * np.sin(2 * np.pi * 220 * t)
    wav[3 * SR: 5 * SR] += 0.3 * np.sin(2 * np.pi * 330 * np.arange(2 * SR) / SR)
    regions = pd.energy_vad(wav, SR)
    assert regions == jd.energy_vad(wav, SR) and len(regions) == 2
    assert pd.energy_vad(np.zeros(SR, np.float32), SR) == jd.energy_vad(np.zeros(SR), SR) == []
    regions += [(7.0, 7.9), (9.0, 12.3)]
    for window, shift in ((1.5, 0.75), (1.0, 0.5)):
        segs = pd.sliding_window_segments(regions, window, shift)
        assert segs == jd.sliding_window_segments(regions, window, shift)
        labels = rs.randint(0, 3, len(segs))
        turns = pd.merge_labeled_segments(segs, labels)
        assert turns == jd.merge_labeled_segments(segs, labels)
        assert pd.to_rttm(turns, "s") == jd.to_rttm(turns, "s")
    assert pd.merge_labeled_segments([], []) == []


def _voice(f0, seconds, seed):
    t = np.arange(int(seconds * SR)) / SR
    return (0.3 * np.sin(2 * np.pi * f0 * t) + 0.15 * np.sin(2 * np.pi * 2 * f0 * t)
            + 0.01 * np.random.RandomState(seed).randn(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def speaker_pair():
    """(JAX speaker model with a jit-initialised state, the port's model on
    its weights)."""
    jm = jal.SpeakerLabelModel(["A", "B"], mel=JaxMel(features=FEATS), **SPK_ARCH)
    feats = jnp.zeros((1, FEATS, 64), jnp.float32)
    variables = jax.jit(lambda: jm.net.init(jax.random.PRNGKey(0), feats,
                                            jnp.full((1,), 64, jnp.int32), train=False))()
    jm.state = JaxTrainState.create(variables["params"], variables.get("batch_stats", {}),
                                    optax.adamw(1e-3).init(variables["params"]),
                                    jax.random.PRNGKey(1))
    pm = pal.SpeakerLabelModel(["A", "B"], mel=MelFeatureConfig(features=FEATS), device="cpu",
                               **SPK_ARCH)
    pm.model.load_state_dict(label_state_dict_from_jax(jax.tree.map(np.asarray, variables),
                                                       pm.model))
    return jm, pm


@pytest.fixture
def compiled_jax(monkeypatch):
    """The JAX model's features and inference forward as compiled programs:
    the same arithmetic as op by op, a fraction of this box's time."""
    cls = jal._EncDecLabelModel
    apply, features = cls._apply, cls._features
    cache = {}

    def _apply(self, state, feats, lens, train=False, rng=None):
        key = ("apply", id(self))
        if key not in cache:
            cache[key] = jax.jit(lambda st, f, l: apply(self, st, f, l))
        return cache[key](state, feats, lens)

    def _features(self, audio, lens, rng=None, training=False):
        key = ("features", id(self))
        if key not in cache:
            cache[key] = jax.jit(lambda a, l: features(self, a, l))
        return cache[key](audio, lens)

    monkeypatch.setattr(cls, "_apply", _apply)
    monkeypatch.setattr(cls, "_features", _features)


@pytest.mark.parametrize("mode", ["oracle_regions", "energy_vad"])
def test_clustering_diarizer_turns_equal_jax(speaker_pair, compiled_jax, tmp_path, mode):
    jm, pm = speaker_pair
    session = np.concatenate([_voice(140, 2.5, 100), _voice(520, 2.5, 101),
                              np.zeros(SR // 2, np.float32), _voice(140, 2.5, 102)])
    path = str(tmp_path / "session.wav")
    write_wav(path, session, SR)
    regions = [(0.0, len(session) / SR)] if mode == "oracle_regions" else None
    jdiar = jd.ClusteringDiarizer(jm, window=1.5, shift=0.75)
    pdiar = pd.ClusteringDiarizer(pm, window=1.5, shift=0.75)
    segs, embs = pdiar.window_embeddings(path, regions)
    want_segs = jd.sliding_window_segments(
        regions if regions is not None else jd.energy_vad(session, SR), 1.5, 0.75)
    assert segs == want_segs and embs.shape == (len(segs), 8)
    wav = jload(path, target_sr=SR)  # the session as the file holds it (PCM16)
    batch = np.stack([jrepeat(wav[int(a * SR): int(b * SR)], int(1.5 * SR)) for a, b in segs])
    jf, jl = jm._features(jnp.asarray(batch), jnp.full((len(segs),), int(1.5 * SR)))
    (_, jemb), _ = jm._apply(jm.state, jf, jl, train=False)
    np.testing.assert_allclose(embs, np.asarray(jemb), atol=EMB_ATOL)
    for oracle in (2, None):
        want = jdiar.diarize(path, oracle_num_speakers=oracle, speech_regions=regions)
        got = pdiar.diarize(path, oracle_num_speakers=oracle, speech_regions=regions)
        assert got == want and got
        assert pd.to_rttm(got, "session") == jd.to_rttm(want, "session")


def test_diarizer_restores_an_archive_on_the_device_asked(speaker_pair, tmp_path):
    _, pm = speaker_pair
    path = str(tmp_path / "spk.cntpu")
    pm.save_portable(path)
    diar = pd.ClusteringDiarizer(path, device="cpu", window=1.0, shift=0.5)
    assert diar.speaker_model.device == torch.device("cpu")
    for a, b in zip(diar.speaker_model.model.state_dict().values(),
                    pm.model.state_dict().values()):
        assert torch.equal(a, b)
    assert diar.window == 1.0 and diar.shift == 0.5 and diar.vad is pd.energy_vad
