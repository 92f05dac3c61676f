"""The port's VAD post-processing (decode/vad.py) and label data pipeline
(data/audio_to_label.py, data/feature_to_label.py) against the JAX
package's, on seeded inputs. Both are host numpy, so results must be
equal: segments, tables, rasters, metrics and tuned parameters exactly,
smoothed probabilities to the 4 decimals both round to.
"""

import json

import numpy as np
import pytest

from conformer_nemo_tpu.data import audio_to_label as jal
from conformer_nemo_tpu.data import feature_to_label as jfl
from conformer_nemo_tpu.decode import vad as jv
from conformer_nemo_tpu_torch.data import audio_to_label as pal
from conformer_nemo_tpu_torch.data import feature_to_label as pfl
from conformer_nemo_tpu_torch.data.audio_io import write_wav
from conformer_nemo_tpu_torch.decode import vad as pv


def _probs(seed, n=400):
    rs = np.random.RandomState(seed)
    # speech-like runs: a smoothed random walk squashed to [0, 1]
    walk = np.convolve(rs.randn(n), np.ones(15) / 15, mode="same") * 4
    return (1 / (1 + np.exp(-walk))).astype(np.float32)


@pytest.mark.parametrize("method,overlap,win,shift", [
    ("mean", 0.875, 0.63, 0.01), ("median", 0.875, 0.63, 0.01), ("median", 0.5, 0.31, 0.02),
    ("mean", 0.5, 0.15, 0.01)])
def test_smoothing_matches_jax(method, overlap, win, shift):
    p = _probs(0)
    np.testing.assert_array_equal(pv.smooth_overlap_predictions(p, method, overlap, win, shift),
                                  jv.smooth_overlap_predictions(p, method, overlap, win, shift))


def test_smoothing_rejects_degenerate_jump():
    for mod in (pv, jv):
        with pytest.raises(ValueError, match="jump_on_frame"):
            mod.smooth_overlap_predictions(_probs(1), "mean", 0.999, 0.05, 0.01)


PARAMS = [
    {},
    {"onset": 0.6, "offset": 0.4, "pad_onset": 0.05, "pad_offset": 0.1},
    {"onset": 0.5, "offset": 0.5, "min_duration_on": 0.2, "min_duration_off": 0.15},
    {"onset": 0.7, "offset": 0.3, "min_duration_on": 0.1, "min_duration_off": 0.3,
     "filter_speech_first": False},
    {"onset": 0.8, "offset": 0.2, "scale": "relative"},
    {"onset": 0.9, "offset": 0.1, "scale": "percentile", "pad_offset": 0.02},
]


@pytest.mark.parametrize("params", PARAMS, ids=[str(i) for i in range(len(PARAMS))])
def test_postprocessing_matches_jax(params):
    for seed in range(3):
        p = _probs(seed)
        segs = pv.postprocess_frame_predictions(p, params)
        assert segs == jv.postprocess_frame_predictions(p, params)
        assert pv.segments_to_table(segs) == jv.segments_to_table(segs)
        np.testing.assert_array_equal(pv.gen_pred_from_speech_segments(segs, len(p)),
                                      jv.gen_pred_from_speech_segments(segs, len(p)))


def test_segment_helpers_match_jax(tmp_path):
    segs = [(0.5, 1.0), (0.9, 1.4), (2.0, 2.05), (3.0, 4.0), (4.2, 5.0)]
    assert pv.merge_overlap_segments(segs) == jv.merge_overlap_segments(segs)
    assert pv.get_gap_segments(segs) == jv.get_gap_segments(segs)
    assert pv.filter_short_segments(segs, 0.1) == jv.filter_short_segments(segs, 0.1)
    for scale in ("absolute", "relative", "percentile"):
        assert (pv.cal_vad_onset_offset(scale, 0.3, 0.6, _probs(2))
                == jv.cal_vad_onset_offset(scale, 0.3, 0.6, _probs(2)))
    pv.write_vad_segment_table(str(tmp_path / "p.txt"), segs)
    jv.write_vad_segment_table(str(tmp_path / "j.txt"), segs)
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()
    texts = ["hello", "", "world", "again", "x"]
    assert (pv.stitch_segmented_transcripts(segs, texts, max_gap=0.7)
            == jv.stitch_segmented_transcripts(segs, texts, max_gap=0.7))


def test_detection_error_and_tuning_match_jax():
    ref = {"a": [(0.5, 1.5), (2.0, 3.0)], "b": [(0.1, 0.4), (1.0, 3.5)]}
    preds = {"a": _probs(3), "b": _probs(4)}
    hyp = pv.postprocess_frame_predictions(preds["a"], {"onset": 0.6, "offset": 0.4})
    assert pv.detection_error_rate(hyp, ref["a"]) == jv.detection_error_rate(hyp, ref["a"])
    grid = {"onset": [0.4, 0.6, 0.8], "offset": [0.3, 0.5], "min_duration_on": [0.0, 0.1],
            "filter_speech_first": True}
    assert pv.get_parameter_grid(grid) == jv.get_parameter_grid(grid)
    for metric in ("DetER", "FA", "MISS"):
        assert (pv.tune_thresholds(grid, preds, ref, focus_metric=metric)
                == jv.tune_thresholds(grid, preds, ref, focus_metric=metric))
    with pytest.raises(ValueError):
        pv.tune_thresholds(grid, preds, ref, focus_metric="F1")


def _label_manifest(tmp_path, n=7, regression=False):
    rs = np.random.RandomState(0)
    rows = []
    for i in range(n):
        dur = 0.3 + 0.1 * i
        path = str(tmp_path / f"c{i}.wav")
        write_wav(path, (0.1 * rs.randn(int(dur * 16000))).astype(np.float32), 16000)
        label = float(i) / 3 if regression else ["yes", "no", "up"][i % 3]
        key = "label" if i % 2 else "command"
        rows.append({"audio_filepath": f"c{i}.wav", "duration": dur, key: label})
    path = str(tmp_path / "labels.json")
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    return path


@pytest.mark.parametrize("regression", [False, True], ids=["labels", "regression"])
def test_label_loader_matches_jax(tmp_path, regression):
    path = _label_manifest(tmp_path, regression=regression)
    kw = dict(is_regression_task=True) if regression else {}
    pds = pal.AudioToLabelDataset(path, sample_rate=16000, min_duration=0.35, **kw)
    jds = jal.AudioToLabelDataset(path, sample_rate=16000, min_duration=0.35, **kw)
    assert pds.labels == jds.labels and len(pds) == len(jds) == 6
    for shuffle in (False, True):
        pl_ = pal.FixedSeqLabelLoader(pds, 4, 0.5, shuffle=shuffle, seed=3)
        jl_ = jal.FixedSeqLabelLoader(jds, 4, 0.5, shuffle=shuffle, seed=3)
        for _ in range(2):  # two epochs: the shuffle seed follows the epoch
            for a, b in zip(pl_, jl_, strict=True):
                for x, y in zip(a[:3], b[:3]):
                    np.testing.assert_allclose(x, y, atol=1e-6)
                assert a[3] == b[3]
    sig = np.arange(5, dtype=np.float32)
    for n in (3, 5, 12, 13):
        np.testing.assert_array_equal(pal.repeat_to_length(sig, n), jal.repeat_to_length(sig, n))
    np.testing.assert_allclose(pal.normalize_signal(sig), jal.normalize_signal(sig))
    assert pal.extract_labels(pds.samples) == jal.extract_labels(jds.samples)


@pytest.mark.parametrize("win,shift,norm", [(0.31, 0.01, False), (0.63, 0.05, True)])
def test_vad_frame_slices_match_jax(win, shift, norm):
    sig = np.random.RandomState(5).randn(16000).astype(np.float32)
    np.testing.assert_array_equal(pal.vad_frame_slices(sig, 16000, win, shift, norm),
                                  jal.vad_frame_slices(sig, 16000, win, shift, norm))


def test_feature_seq_labels_match_jax(tmp_path):
    rs = np.random.RandomState(6)
    rows = []
    for i, (dtype, ext) in enumerate([(np.float32, "npy"), (np.int16, "npy"),
                                      (np.float64, "npz")]):
        feats = (rs.randn(10, 4) * 1000).astype(dtype)
        path = str(tmp_path / f"f{i}.{ext}")
        if ext == "npz":
            np.savez(path, feats)
        else:
            np.save(path, feats)
        rows.append({"feature_filepath": path, "seq_label": "spkA spkB spkA"})
    manifest = str(tmp_path / "feats.json")
    with open(manifest, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    pds = pfl.FeatureToSeqSpeakerLabelDataset(manifest)
    jds = jfl.FeatureToSeqSpeakerLabelDataset(manifest)
    assert pds.labels == jds.labels
    for a, b in zip(pfl.FeatureSeqLabelLoader(pds, 2, shuffle=True, seed=1),
                    jfl.FeatureSeqLabelLoader(jds, 2, shuffle=True, seed=1), strict=True):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
