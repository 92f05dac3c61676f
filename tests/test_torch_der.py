"""The port's DER scoring and RTTM helpers (decode/der.py) against the JAX
package's, on the CPU: equal results, not merely close (both are the same
host arithmetic in float64).

Random overlapping segment sets of two to four speakers (seeded numpy),
scored with and without a collar and with and without reference overlap
skipped; the speaker mapping; the RTTM text and its round trip; the
cumulative score over files.
"""

import numpy as np
import pytest

from conformer_nemo_tpu.decode import der as jder
from conformer_nemo_tpu_torch.decode import der as pder


def _segments(rs, n: int, speakers: int, prefix: str) -> list:
    """n segments of 0.3-6 s anywhere in 60 s, overlapping freely."""
    out = []
    for _ in range(n):
        start = round(float(rs.uniform(0.0, 54.0)), 3)
        out.append((start, round(start + float(rs.uniform(0.3, 6.0)), 3),
                    f"{prefix}{rs.randint(speakers)}"))
    return out


CASES = [(seed, collar, overlap) for seed in range(4) for collar in (0.0, 0.25)
         for overlap in (True, False)]


@pytest.mark.parametrize("seed,collar,ignore_overlap", CASES)
def test_der_score_equals_jax(seed, collar, ignore_overlap):
    rs = np.random.RandomState(seed)
    ref = _segments(rs, 12 + seed, 2 + seed % 3, "spk")
    hyp = _segments(rs, 10 + 2 * seed, 2 + (seed + 1) % 3, "h")
    want = jder.der_score(ref, hyp, collar, ignore_overlap)
    got = pder.der_score(ref, hyp, collar, ignore_overlap)
    assert got == want
    assert got["total_speech_s"] > 0


def test_mapping_and_edge_cases_equal_jax():
    rs = np.random.RandomState(7)
    ref = _segments(rs, 9, 3, "spk")
    hyp = _segments(rs, 9, 4, "h")
    assert pder.optimal_speaker_mapping(ref, hyp) == jder.optimal_speaker_mapping(ref, hyp)
    for r, h in (([], hyp), (ref, []), ([], [])):
        assert pder.der_score(r, h) == jder.der_score(r, h)
    # a hypothesis speaker that overlaps no reference speaker stays unmapped
    far = [(100.0, 101.0, "lonely")] + hyp
    assert pder.der_score(ref, far) == jder.der_score(ref, far)


def test_rttm_text_round_trip_and_cumulative_score_equal_jax(tmp_path):
    rs = np.random.RandomState(3)
    pairs = []
    for i in range(3):
        ref = _segments(rs, 8, 2, "spk")
        hyp = _segments(rs, 8, 3, "h")
        assert pder.segments_to_rttm(ref, f"f{i}") == jder.segments_to_rttm(ref, f"f{i}")
        r_path = pder.write_rttm(str(tmp_path / f"ref{i}.rttm"), ref, f"f{i}")
        h_path = str(tmp_path / f"hyp{i}.rttm")
        jder.write_rttm(h_path, hyp, f"f{i}")
        assert pder.rttm_to_segments(r_path) == jder.rttm_to_segments(r_path)
        assert pder.rttm_to_segments(h_path) == jder.rttm_to_segments(h_path)
        # the text keeps three decimals: the segments read back within 1 ms
        back = pder.rttm_to_segments(r_path)
        assert [s for _, _, s in back] == [s for _, _, s in ref]
        assert np.allclose([a for a, _, _ in back], [a for a, _, _ in ref], atol=1e-3)
        pairs.append((r_path, h_path))
    assert pder.segments_to_rttm([], "x") == jder.segments_to_rttm([], "x") == ""
    for collar, overlap in ((0.25, True), (0.0, False)):
        assert pder.score_rttm_files(pairs, collar, overlap) == \
            jder.score_rttm_files(pairs, collar, overlap)
