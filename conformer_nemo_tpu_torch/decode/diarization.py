"""Speaker diarization: NME-SC clustering and a clustering diarizer (port of
conformer_nemo_tpu/decode/diarization.py).

    diar = ClusteringDiarizer(speaker_model)         # or a speaker .cntpu, on `device`
    turns = diar.diarize("session.wav", oracle_num_speakers=2)
    print(to_rttm(turns, "session"))

- NME-SC (normalised maximum eigengap spectral clustering): a min-max
  scaled cosine affinity, a top-p binarised and symmetrised graph, the
  unnormalised Laplacian's eigengap as the speaker count, the p-value
  search that minimises g_p = (p / N) / max eigengap (on a subsample past
  `nme_mat_size` rows), anchor-embedding counting for short recordings,
  then the first k eigenvectors through k-means.
- The pipeline: VAD (an energy gate, or `vad=` such as
  `ClassificationModel.as_vad_callable()`), sliding windows over the speech
  regions, one batch of every window (repeated to the window's length)
  through the speaker model's features and forward, NME-SC, and the
  labelled windows merged into speaker turns.

The clustering is the JAX package's host numpy in float64 (`np.linalg`
eigendecompositions, its own seeded k-means), so the labels are the JAX
package's exactly; the speaker model's forward is the only device work
(api_label.py `SpeakerLabelModel._infer`: fp32, cuDNN's TF32 off).
Single-scale embeddings; multi-scale fusion is out of scope in both
packages.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


# -- the affinity graph ----------------------------------------------------------

def cos_affinity_matrix(emb: np.ndarray) -> np.ndarray:
    """Cosine similarity, then per-column min-max scaling to [0, 1]."""
    normed = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    sim = normed @ normed.T
    lo, hi = sim.min(axis=0, keepdims=True), sim.max(axis=0, keepdims=True)
    return (sim - lo) / np.maximum(hi - lo, 1e-12)


def binarize_top_p(affinity: np.ndarray, p_value: int) -> np.ndarray:
    """Keep each column's top-p entries: row i's p largest indices j set
    [j, i] to 1."""
    n = affinity.shape[0]
    out = np.zeros_like(affinity)
    top = np.argsort(-affinity, axis=1)[:, : max(p_value, 1)]
    rows = np.repeat(np.arange(n), top.shape[1])
    out[top.ravel(), rows] = 1.0
    return out


def affinity_graph(affinity: np.ndarray, p_value: int) -> np.ndarray:
    """The binarised graph, symmetrised."""
    x = binarize_top_p(affinity, p_value)
    return 0.5 * (x + x.T)


def is_fully_connected(affinity: np.ndarray) -> bool:
    n = affinity.shape[0]
    reached = np.zeros(n, bool)
    frontier = np.zeros(n, bool)
    frontier[0] = True
    while True:
        new = reached | frontier
        if new.sum() == reached.sum():
            break
        reached = new
        frontier = (affinity[frontier].sum(axis=0) > 0) & ~reached
        if not frontier.any():
            break
    return bool(reached.sum() == n)


def laplacian(affinity: np.ndarray) -> np.ndarray:
    a = affinity.copy()
    np.fill_diagonal(a, 0.0)
    return np.diag(np.abs(a).sum(axis=1)) - a


def estimate_num_speakers(affinity: np.ndarray,
                          max_num_speakers: int) -> Tuple[int, np.ndarray, np.ndarray]:
    """The eigengap estimate on the unnormalised Laplacian -> (k, sorted
    eigenvalues, their gaps)."""
    lambdas = np.sort(np.real(np.linalg.eigvalsh(laplacian(affinity))))
    gaps = lambdas[1:] - lambdas[:-1]
    k = int(np.argmax(gaps[: min(max_num_speakers, len(gaps))])) + 1
    return k, lambdas, gaps


# -- NME-SC ----------------------------------------------------------------------

@dataclasses.dataclass
class NMESC:
    """The p-value search that minimises g_p."""

    mat: np.ndarray
    max_num_speakers: int = 8
    max_rp_threshold: float = 0.25
    sparse_search: bool = True
    sparse_search_volume: int = 30
    fixed_thres: Optional[float] = None
    nme_mat_size: int = 300
    eps: float = 1e-10

    def analyze(self) -> Tuple[int, int]:
        """-> (estimated number of speakers, p for the full matrix)."""
        full_n = self.mat.shape[0]
        mat = self.mat
        subsample_ratio = 1
        if self.nme_mat_size and full_n > self.nme_mat_size:
            subsample_ratio = int(max(1, full_n / self.nme_mat_size))
            mat = mat[::subsample_ratio, ::subsample_ratio]

        p_values, max_n = self._p_value_list(mat.shape[0])
        best_gp, best_p, best_k = np.inf, p_values[0], 1
        est_by_p = {}
        for p in p_values:
            k, g_p = self._eig_ratio(mat, p)
            est_by_p[p] = k
            if g_p < best_gp:
                best_gp, best_p, best_k = g_p, p, k

        graph = affinity_graph(mat, best_p)
        if not is_fully_connected(graph):
            # the least p whose graph is connected
            for p in p_values:
                graph = affinity_graph(mat, p)
                if is_fully_connected(graph) or p > max_n:
                    best_p = p
                    break
            best_k = est_by_p.get(best_p, best_k)
        return best_k, int(subsample_ratio * best_p)

    def _p_value_list(self, n: int) -> Tuple[List[int], int]:
        if self.fixed_thres:
            p = max(int(n * self.fixed_thres), 1)
            return [p], p
        max_n = max(int(n * self.max_rp_threshold), 2)
        if self.sparse_search:
            count = min(max_n, self.sparse_search_volume)
            ps = np.unique(np.linspace(1, max_n, count, endpoint=True).astype(int))
            return list(ps), max_n
        return list(range(1, max_n)), max_n

    def _eig_ratio(self, mat: np.ndarray, p_neighbors: int) -> Tuple[int, float]:
        graph = affinity_graph(mat, p_neighbors)
        k, lambdas, gaps = estimate_num_speakers(graph, self.max_num_speakers)
        max_gap = np.max(gaps[: self.max_num_speakers]) / (lambdas.max() + self.eps)
        g_p = (p_neighbors / mat.shape[0]) / (max_gap + self.eps)
        return k, g_p


def _kmeans(x: np.ndarray, k: int, n_init: int = 10, seed: int = 0,
            iters: int = 100) -> np.ndarray:
    """Lloyd's k-means from k-means++ seeds, n_init restarts, the least
    inertia kept."""
    rs = np.random.RandomState(seed)
    best_labels, best_inertia = None, np.inf
    for _ in range(n_init):
        centers = [x[rs.randint(len(x))]]
        for _ in range(1, k):
            d2 = np.min([np.sum((x - c) ** 2, axis=1) for c in centers], axis=0)
            probs = d2 / max(d2.sum(), 1e-12)
            centers.append(x[rs.choice(len(x), p=probs)])
        c = np.stack(centers)
        for _ in range(iters):
            d = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
            labels = d.argmin(axis=1)
            new_c = np.stack([x[labels == j].mean(axis=0) if (labels == j).any() else c[j]
                              for j in range(k)])
            if np.allclose(new_c, c):
                break
            c = new_c
        inertia = float(((x - c[labels]) ** 2).sum())
        if inertia < best_inertia:
            best_inertia, best_labels = inertia, labels
    return best_labels


def spectral_cluster(affinity: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    """The Laplacian's first k eigenvectors through k-means."""
    _, vecs = np.linalg.eigh(laplacian(affinity))
    return _kmeans(vecs[:, :k], k, seed=seed)


def _enhanced_speaker_count(emb: np.ndarray, random_test_count: int = 5,
                            anchor_spk_n: int = 3, anchor_sample_n: int = 10,
                            sigma: float = 50.0) -> int:
    """Speaker counting for short recordings: anchor clusters drawn around
    random means are added, NME-SC counts, the anchors are subtracted; the
    most common count over `random_test_count` seeded draws."""
    estimates = []
    emb_dim = emb.shape[1]
    std_org = np.std(emb, axis=0)
    for seed in range(random_test_count):
        rs = np.random.RandomState(seed)
        blocks = []
        for _ in range(anchor_spk_n):
            mean = np.tile(rs.randn(1, emb_dim), (anchor_sample_n, 1))
            noise = rs.randn(anchor_sample_n, emb_dim).T
            noise = (np.diag(std_org) @ (noise / np.max(np.abs(noise)))).T
            blocks.append(mean + sigma * noise)
        blocks.append(emb)
        aug = np.vstack(blocks)
        k, _ = NMESC(cos_affinity_matrix(aug), max_num_speakers=emb.shape[0]).analyze()
        estimates.append(k)
    common = Counter(estimates).most_common(1)[0][0]
    return max(common - anchor_spk_n, 1)


def nme_spectral_clustering(embeddings: np.ndarray, oracle_num_speakers: Optional[int] = None,
                            max_num_speakers: int = 8, min_samples_for_nmesc: int = 6,
                            enhanced_count_thres: int = 80, max_rp_threshold: float = 0.25,
                            sparse_search_volume: int = 30,
                            fixed_thres: Optional[float] = None, seed: int = 0) -> np.ndarray:
    """Speaker embeddings [N, D] -> cluster labels [N]."""
    emb = np.asarray(embeddings, np.float64)
    n = emb.shape[0]
    if n == 1:
        return np.array([0])

    est_enhanced = None
    if n <= max(enhanced_count_thres, min_samples_for_nmesc) and oracle_num_speakers is None:
        est_enhanced = _enhanced_speaker_count(emb)

    if oracle_num_speakers:
        max_num_speakers = oracle_num_speakers

    mat = cos_affinity_matrix(emb)
    nmesc = NMESC(mat, max_num_speakers=max_num_speakers, max_rp_threshold=max_rp_threshold,
                  sparse_search_volume=sparse_search_volume, fixed_thres=fixed_thres)

    if n > min_samples_for_nmesc:
        est_k, p_hat = nmesc.analyze()
        affinity = affinity_graph(mat, p_hat)
    else:
        est_k, affinity = 1, mat

    if oracle_num_speakers:
        est_k = oracle_num_speakers
    elif est_enhanced:
        est_k = est_enhanced

    return spectral_cluster(affinity, max(est_k, 1), seed=seed)


# -- the pipeline ----------------------------------------------------------------

def energy_vad(wav: np.ndarray, sr: int, frame_sec: float = 0.05, threshold_db: float = -40.0,
               min_speech_sec: float = 0.2,
               floor_db: float = -55.0) -> List[Tuple[float, float]]:
    """Speech regions [(start_s, end_s)] of frames within `threshold_db` of
    the loudest and above the absolute `floor_db` (so silence alone gives
    none); regions shorter than `min_speech_sec` dropped."""
    frame = max(int(frame_sec * sr), 1)
    n = len(wav) // frame
    if n == 0:
        return []
    e = (wav[: n * frame].reshape(n, frame) ** 2).mean(axis=1)
    db = 10 * np.log10(e + 1e-12)
    ref = db.max()
    speech = (db > (ref + threshold_db)) & (db > floor_db)
    regions, start = [], None
    for i, s in enumerate(speech):
        if s and start is None:
            start = i
        elif not s and start is not None:
            regions.append((start * frame_sec, i * frame_sec))
            start = None
    if start is not None:
        regions.append((start * frame_sec, n * frame_sec))
    return [(a, b) for a, b in regions if b - a >= min_speech_sec]


def sliding_window_segments(regions: Sequence[Tuple[float, float]], window: float = 1.5,
                            shift: float = 0.75) -> List[Tuple[float, float]]:
    """Overlapping windows over the speech regions; a region's tail gets a
    last window that ends at its end."""
    segs = []
    for start, end in regions:
        t = start
        while t + window <= end + 1e-9:
            segs.append((t, t + window))
            t += shift
        if not segs or segs[-1][1] < end - 1e-9:
            segs.append((max(end - window, start), end))
    return segs


def merge_labeled_segments(segments: Sequence[Tuple[float, float]],
                           labels: Sequence[int]) -> List[Tuple[float, float, int]]:
    """Overlapping neighbours split at the midpoint of their overlap, then
    adjacent windows of one speaker merged -> [(start, end, label)]."""
    if not segments:
        return []
    order = np.argsort([s[0] for s in segments])
    segs = [list(segments[i]) + [labels[i]] for i in order]
    for i in range(len(segs) - 1):
        if segs[i][1] > segs[i + 1][0]:
            mid = (segs[i][1] + segs[i + 1][0]) / 2
            segs[i][1] = mid
            segs[i + 1][0] = mid
    merged = [segs[0]]
    for s in segs[1:]:
        if s[2] == merged[-1][2] and abs(s[0] - merged[-1][1]) < 1e-6:
            merged[-1][1] = s[1]
        else:
            merged.append(s)
    return [(a, b, l) for a, b, l in merged]


def to_rttm(segments: Sequence[Tuple[float, float, int]], uniq_id: str) -> str:
    """Speaker turns -> RTTM lines (speaker names `speaker_<label>`)."""
    lines = []
    for start, end, label in segments:
        lines.append(f"SPEAKER {uniq_id} 1 {start:.3f} {end - start:.3f} "
                     f"<NA> <NA> speaker_{label} <NA> <NA>")
    return "\n".join(lines) + "\n"


class ClusteringDiarizer:
    """VAD -> sliding windows -> speaker embeddings -> NME-SC -> merged turns.

    `speaker_model`: a `SpeakerLabelModel` (api_label.py), or the path of a
    speaker `.cntpu`, restored on `device` (None: CUDA, raising without a
    GPU). `vad`: a (wav, sr) -> regions function in place of the energy
    VAD."""

    def __init__(self, speaker_model, window: float = 1.5, shift: float = 0.75,
                 vad: Optional[Callable] = None, device=None):
        if isinstance(speaker_model, str):
            from conformer_nemo_tpu_torch.api_label import SpeakerLabelModel

            speaker_model = SpeakerLabelModel.restore_portable(speaker_model, device=device)
        self.speaker_model = speaker_model
        self.window = window
        self.shift = shift
        self.vad = vad or energy_vad

    def window_embeddings(self, audio_path: str,
                          speech_regions: Optional[Sequence[Tuple[float, float]]] = None
                          ) -> Tuple[List[Tuple[float, float]], np.ndarray]:
        """-> (the windows [(start, end)], their embeddings [N, D] float32):
        every window repeated to the window's length, one batch."""
        from conformer_nemo_tpu_torch.data.audio_io import load_audio
        from conformer_nemo_tpu_torch.data.audio_to_label import repeat_to_length

        m = self.speaker_model
        sr = m.sample_rate
        wav = load_audio(audio_path, target_sr=sr)
        regions = list(speech_regions) if speech_regions is not None else self.vad(wav, sr)
        segments = sliding_window_segments(regions, self.window, self.shift)
        if not segments:
            return [], np.zeros((0, 0), np.float32)
        t_fixed = int(self.window * sr)
        batch = np.zeros((len(segments), t_fixed), np.float32)
        for i, (a, b) in enumerate(segments):
            batch[i] = repeat_to_length(wav[int(a * sr): int(b * sr)], t_fixed)
        _logits, embs = m._infer(batch, np.full((len(segments),), t_fixed, np.int32))
        return segments, embs.cpu().numpy()

    def diarize(self, audio_path: str, oracle_num_speakers: Optional[int] = None,
                speech_regions: Optional[Sequence[Tuple[float, float]]] = None,
                max_num_speakers: int = 8) -> List[Tuple[float, float, int]]:
        """-> speaker turns [(start_s, end_s, label)]."""
        segments, embs = self.window_embeddings(audio_path, speech_regions)
        if not segments:
            return []
        labels = nme_spectral_clustering(embs, oracle_num_speakers=oracle_num_speakers,
                                         max_num_speakers=max_num_speakers)
        return merge_labeled_segments(segments, labels)
