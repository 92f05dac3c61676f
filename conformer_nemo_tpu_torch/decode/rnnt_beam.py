"""RNN-T beam search: default (ESPnet-style), TSD, ALSD and mAES (port of
conformer_nemo_tpu/decode/rnnt_beam.py).

NeMo's `BeamRNNTInfer` (nemo/collections/asr/parts/submodules/
rnnt_beam_decoding.py) is the behaviour:
  * default (:465): score-ordered expansion per frame; beam_k label
    candidates and blank; stop when `beam` kept hypotheses outscore the
    best open one.
  * tsd (:592): time-synchronous decoding (Saon et al. 2020), at most
    `tsd_max_sym_exp` expansions a frame, prefix recombination.
  * alsd (:712): alignment-length synchronous decoding on n = t + u, the
    target length capped at `alsd_max_target_len` (a float: a fraction of T).
  * maes (:896): modified adaptive expansion search (Kim et al. 2020):
    prune-by-value gamma, `maes_num_steps` expansions a frame, prefix merge.
  * score_norm: the final sort by score / len(y_sequence) (:360-372).

The search control runs on the host, as in the JAX package, with its numpy
ordering (`np.argsort(...)[::-1]`, the dict order of `_recombine`), so
that ties resolve the same way on the same log-probs. The leaf ops run on
the model's device, batched over the hypotheses a step scores: the
prediction network's step (cached per label sequence, with its joint
projection), and the joint's fp32 log-softmax. A hypothesis's LSTM state
stays on the device; each joint call reads back only the log-probs the
search needs: one host read a call.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from conformer_nemo_tpu_torch.models.conformer import _linear


@dataclasses.dataclass(eq=False)  # identity: `list.remove` must not compare device states
class Hypothesis:
    score: float
    y_sequence: List[int]
    dec_state: tuple  # (h [L, 1, H], c [L, 1, H]) on the model's device
    timestep: List[int]

    def key(self) -> tuple:
        return tuple(self.y_sequence)


def _sort_nbest(hyps: List[Hypothesis], score_norm: bool) -> List[Hypothesis]:
    if score_norm:
        return sorted(hyps, key=lambda x: x.score / max(len(x.y_sequence), 1), reverse=True)
    return sorted(hyps, key=lambda x: x.score, reverse=True)


def _logsumexp(a: float, b: float) -> float:
    m = max(a, b)
    return m + float(np.log(np.exp(a - m) + np.exp(b - m)))


def _recombine(hyps: List[Hypothesis]) -> List[Hypothesis]:
    """Merge hypotheses with the same label sequence (logsumexp of scores)."""
    merged: dict = {}
    for h in hyps:
        k = h.key()
        if k in merged:
            merged[k].score = _logsumexp(merged[k].score, h.score)
        else:
            merged[k] = h
    return list(merged.values())


def _best(hyps: List[Hypothesis], beam: int) -> List[Hypothesis]:
    return sorted(_recombine(hyps), key=lambda x: x.score, reverse=True)[:beam]


def _label_order(row: np.ndarray, blank: int, k: int) -> tuple:
    """The k best labels of one log-prob row, blank left out: (scores of
    the labels, their ids, positions of the k best in descending order)."""
    nb = np.delete(row, blank)
    ids = np.delete(np.arange(row.shape[0]), blank)
    return nb, ids, np.argsort(nb)[::-1][:k]


class BeamRNNTInfer:
    """Per-sample beam search over an RNNTModel (eval mode) of the port."""

    def __init__(self, model, beam_size: int = 4, search_type: str = "default",
                 score_norm: bool = True, tsd_max_sym_exp: int = 50,
                 alsd_max_target_len: float = 1.0, maes_num_steps: int = 2,
                 maes_expansion_gamma: float = 2.3, maes_expansion_beta: int = 2,
                 softmax_temperature: float = 1.0, return_best_hypothesis: bool = True):
        self.model = model
        self.blank = model.cfg.blank_id
        self.vocab_size = model.cfg.decoder.vocab_size
        self.beam_size = max(1, min(beam_size, self.vocab_size))
        self.search_type = search_type
        self.score_norm = score_norm
        self.tsd_max_sym_exp = tsd_max_sym_exp
        self.alsd_max_target_len = alsd_max_target_len
        self.maes_num_steps = maes_num_steps
        self.maes_expansion_gamma = maes_expansion_gamma
        self.maes_expansion_beta = maes_expansion_beta
        self.temp = softmax_temperature
        self.return_best = return_best_hypothesis
        self._search = {
            "default": self.default_beam_search,
            "beam": self.default_beam_search,
            "tsd": self.time_sync_decoding,
            "alsd": self.align_length_sync_decoding,
            "maes": self.modified_adaptive_expansion_search,
        }[search_type]

    # -- leaf ops on the device, batched over hypotheses -------------------
    def _score_hyps(self, hyps: List[Hypothesis], cache: dict) -> list:
        """The prediction network's step for each hypothesis's last label,
        batched over those not in `cache`. -> [(p, state)] per hypothesis:
        p its joint projection [Hj] and state the LSTM state after it."""
        missing = [h for h in hyps if h.key() not in cache]
        if missing:
            dec, joint = self.model.decoder, self.model.joint
            dev = missing[0].dec_state[0].device
            labels = torch.tensor([h.y_sequence[-1] if h.y_sequence else self.blank
                                   for h in missing], dtype=torch.int64, device=dev)
            state = (torch.cat([h.dec_state[0] for h in missing], dim=1),
                     torch.cat([h.dec_state[1] for h in missing], dim=1))
            g, (nh, nc) = dec.step(labels, state)
            p = _linear(joint.pred, g, joint.cfg.dtype)
            for i, h in enumerate(missing):
                cache[h.key()] = (p[i], (nh[:, i: i + 1], nc[:, i: i + 1]))
        return [cache[h.key()] for h in hyps]

    def _joint(self, e: torch.Tensor, ps: list) -> np.ndarray:
        """log-softmax over V+1 of the joint of each p in `ps` with the
        projected frames `e` ([Hj], or [N, Hj] one per p). -> [N, V+1] numpy."""
        logits = self.model.joint.combine(e + torch.stack(ps))
        return torch.log_softmax(logits.float() / self.temp, dim=-1).cpu().numpy()

    def _init_hyp(self, dev) -> Hypothesis:
        return Hypothesis(0.0, [], self.model.decoder.zero_state(1, dev), [])

    # -- public API --------------------------------------------------------
    @torch.no_grad()
    def __call__(self, enc: torch.Tensor, enc_lens) -> list:
        """enc [B, T, D] on the model's device, enc_lens [B] -> per sample
        the best Hypothesis, or with return_best_hypothesis False the
        sorted n-best list."""
        joint = self.model.joint
        lens = torch.as_tensor(enc_lens).tolist()
        out = []
        for b, t_len in enumerate(lens):
            e = _linear(joint.enc, enc[b, : int(t_len)], joint.cfg.dtype)  # [T, Hj]
            nbest = _sort_nbest(self._search(e), self.score_norm)
            out.append(nbest[0] if self.return_best else nbest)
        return out

    # -- strategies ------------------------------------------------------------
    def default_beam_search(self, e: torch.Tensor) -> List[Hypothesis]:
        """Score-ordered expansion (rnnt_beam_decoding.py:465-590)."""
        beam = self.beam_size
        beam_k = min(beam, self.vocab_size)
        cache: dict = {}
        kept = [self._init_hyp(e.device)]
        for t in range(e.shape[0]):
            hyps = kept
            kept = []
            while True:
                max_hyp = max(hyps, key=lambda x: x.score)
                hyps.remove(max_hyp)
                p, state = self._score_hyps([max_hyp], cache)[0]
                logp = self._joint(e[t], [p])[0]
                # blank keeps the sequence and moves to the next frame
                kept.append(Hypothesis(max_hyp.score + float(logp[self.blank]),
                                       max_hyp.y_sequence[:], max_hyp.dec_state,
                                       max_hyp.timestep[:]))
                # the k best labels stay in the open set
                nb, ids, order = _label_order(logp, self.blank, beam_k)
                for j in order:
                    hyps.append(Hypothesis(max_hyp.score + float(nb[j]),
                                           max_hyp.y_sequence + [int(ids[j])], state,
                                           max_hyp.timestep + [t]))
                hyps_max = max(hyps, key=lambda x: x.score).score
                kept_best = [h for h in kept if h.score > hyps_max]
                if len(kept_best) >= beam:
                    kept = sorted(kept_best, key=lambda x: x.score, reverse=True)[:beam]
                    break
        return kept

    def time_sync_decoding(self, e: torch.Tensor) -> List[Hypothesis]:
        """TSD (rnnt_beam_decoding.py:592-710; Saon et al. 2020, Alg. 1)."""
        beam = self.beam_size
        cache: dict = {}
        B = [self._init_hyp(e.device)]
        for t in range(e.shape[0]):
            A: List[Hypothesis] = []  # closed by a blank in this frame
            C = B
            for v in range(self.tsd_max_sym_exp):
                if not C:
                    break
                D: List[Hypothesis] = []
                scored = self._score_hyps(C, cache)
                logps = self._joint(e[t], [p for p, _ in scored])
                for i, h in enumerate(C):
                    A.append(Hypothesis(h.score + float(logps[i, self.blank]), h.y_sequence[:],
                                        h.dec_state, h.timestep[:]))
                if v < self.tsd_max_sym_exp - 1:
                    for i, h in enumerate(C):
                        state = scored[i][1]
                        nb, ids, order = _label_order(logps[i], self.blank, beam)
                        for j in order:
                            D.append(Hypothesis(h.score + float(nb[j]),
                                                h.y_sequence + [int(ids[j])], state,
                                                h.timestep + [t]))
                C = _best(D, beam)
            B = _best(A, beam)
        return B

    def align_length_sync_decoding(self, e: torch.Tensor) -> List[Hypothesis]:
        """ALSD (rnnt_beam_decoding.py:712-894; Saon et al. 2020, Alg. 2):
        hypotheses synchronised on n = t + u, so t = n - len(y)."""
        beam = self.beam_size
        t_max = e.shape[0]
        if isinstance(self.alsd_max_target_len, float):
            u_max = int(self.alsd_max_target_len * t_max)
        else:
            u_max = int(self.alsd_max_target_len)
        cache: dict = {}
        B = [self._init_hyp(e.device)]
        final: List[Hypothesis] = []
        for n in range(t_max + u_max):
            A: List[Hypothesis] = []
            live = [(h, n - len(h.y_sequence)) for h in B if 0 <= n - len(h.y_sequence) < t_max]
            if not live:
                break
            scored = self._score_hyps([h for h, _ in live], cache)
            # each hypothesis against its own frame
            logps = self._joint(e[torch.tensor([t for _, t in live], device=e.device)],
                                [p for p, _ in scored])
            for i, (h, t) in enumerate(live):
                blank_ext = Hypothesis(h.score + float(logps[i, self.blank]), h.y_sequence[:],
                                       h.dec_state, h.timestep[:])
                A.append(blank_ext)
                if t == t_max - 1:
                    final.append(blank_ext)
                state = scored[i][1]
                nb, ids, order = _label_order(logps[i], self.blank, beam)
                for j in order:
                    A.append(Hypothesis(h.score + float(nb[j]), h.y_sequence + [int(ids[j])],
                                        state, h.timestep + [t]))
            B = _best(A, beam)
        return final if final else B

    def _prefix_merge(self, hyps: List[Hypothesis], e_t: torch.Tensor, cache: dict):
        """mAES prefix search (rnnt_beam_decoding.py:1134): where hyp_i's
        labels are hyp_j's less its last one, fold hyp_i's probability of
        emitting that label into hyp_j's score. (Longer completions,
        maes_prefix_alpha > 1, are approximated by single-label merges
        across frames.)"""
        for j, hj in enumerate(hyps):
            if not hj.y_sequence:
                continue
            for i, hi in enumerate(hyps):
                if i == j or len(hj.y_sequence) - len(hi.y_sequence) != 1:
                    continue
                if hj.y_sequence[:-1] != hi.y_sequence:
                    continue
                p_i, _ = self._score_hyps([hi], cache)[0]
                logp = self._joint(e_t, [p_i])[0]
                hj.score = _logsumexp(hj.score, hi.score + float(logp[hj.y_sequence[-1]]))
        return hyps

    def modified_adaptive_expansion_search(self, e: torch.Tensor) -> List[Hypothesis]:
        """mAES (rnnt_beam_decoding.py:896-1110; Kim et al. 2020)."""
        beam = self.beam_size
        cache: dict = {}
        kept = [self._init_hyp(e.device)]
        for t in range(e.shape[0]):
            hyps = self._prefix_merge(kept, e[t], cache)
            for step in range(self.maes_num_steps):
                scored = self._score_hyps(hyps, cache)
                logps = self._joint(e[t], [p for p, _ in scored])
                kept_new: List[Hypothesis] = []
                expanding: List[Hypothesis] = []
                for i, h in enumerate(hyps):
                    row = logps[i]
                    # prune by value: the candidates within gamma of the best,
                    # at most beam + beta of them
                    cand = np.where(row >= float(row.max()) - self.maes_expansion_gamma)[0]
                    if cand.shape[0] > beam + self.maes_expansion_beta:
                        cand = cand[np.argsort(row[cand])[::-1][: beam + self.maes_expansion_beta]]
                    for k in cand:
                        new = Hypothesis(h.score + float(row[k]), h.y_sequence[:], h.dec_state,
                                         h.timestep[:])
                        if int(k) == self.blank:
                            kept_new.append(new)
                        else:
                            new.y_sequence.append(int(k))
                            new.timestep.append(t)
                            new.dec_state = scored[i][1]
                            expanding.append(new)
                if step == self.maes_num_steps - 1:
                    # the last step closes what still expands with its blank score
                    if expanding:
                        scored2 = self._score_hyps(expanding, cache)
                        logps2 = self._joint(e[t], [p for p, _ in scored2])
                        for i, h in enumerate(expanding):
                            h.score += float(logps2[i, self.blank])
                            kept_new.append(h)
                    kept = _best(kept_new, beam)
                    break
                if not expanding:
                    kept = _best(kept_new, beam)
                    break
                hyps = _best(expanding, beam)
                if kept_new:
                    kept = _best(kept_new + kept, beam)
        return kept
