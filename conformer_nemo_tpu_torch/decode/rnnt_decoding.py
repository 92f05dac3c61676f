"""RNN-T decoding facade (port of conformer_nemo_tpu/decode/rnnt_decoding.py):
the `decoding` config's strategy -> token ids -> text.

NeMo's `RNNTDecoding` (nemo/collections/asr/metrics/rnnt_wer.py:116-370)
maps `strategy` to a decoder: greedy and greedy_batch run the batched
greedy decoder; beam, tsd, alsd and maes the per-sample searches of
`BeamRNNTInfer` (decode/rnnt_beam.py); beam_batch the batched beam on the
device (decode/rnnt_beam_batched.py), which NeMo has no analogue of. The
defaults are the JAX package's: beam_size 2 for the per-sample searches
and 4 for beam_batch, tsd_max_sym_exp 50 (2 for beam_batch),
alsd_max_target_len 1.0 (a float: a fraction of T).
"""

from __future__ import annotations

from typing import List, Optional

from conformer_nemo_tpu_torch.decode.rnnt_beam import BeamRNNTInfer
from conformer_nemo_tpu_torch.decode.rnnt_beam_batched import rnnt_beam_batched_decode
from conformer_nemo_tpu_torch.decode.rnnt_greedy import rnnt_greedy_decode_batched

GREEDY = ("greedy", "greedy_batch")
BEAM = ("beam", "tsd", "alsd", "maes", "beam_batch")


class RNNTDecoding:
    """cfg: the reference-shaped `decoding` dict."""

    def __init__(self, model, tokenizer, cfg: Optional[dict] = None):
        cfg = cfg or {}
        self.model = model
        self.tokenizer = tokenizer
        self.strategy = cfg.get("strategy", "greedy_batch")
        if self.strategy not in GREEDY + BEAM:
            raise ValueError(f"unknown decoding strategy {self.strategy!r}")
        greedy = cfg.get("greedy") or {}
        self.max_symbols = int(greedy.get("max_symbols", 10) or 10)
        self.preserve_alignments = bool(greedy.get("preserve_alignments", False))
        self.last_alignments = None
        beam = self._beam_cfg = cfg.get("beam") or {}
        self._beam = None
        if self.strategy in ("beam", "tsd", "alsd", "maes"):
            self._beam = BeamRNNTInfer(
                model, beam_size=int(beam.get("beam_size", 2)),
                search_type="default" if self.strategy == "beam" else self.strategy,
                score_norm=bool(beam.get("score_norm", True)),
                tsd_max_sym_exp=int(beam.get("tsd_max_sym_exp", 50)),
                alsd_max_target_len=beam.get("alsd_max_target_len", 1.0),
                return_best_hypothesis=bool(beam.get("return_best_hypothesis", True)),
                maes_num_steps=int(beam.get("maes_num_steps", 2)),
                maes_expansion_gamma=float(beam.get("maes_expansion_gamma", 2.3)),
                maes_expansion_beta=int(beam.get("maes_expansion_beta", 2)),
                softmax_temperature=float(beam.get("softmax_temperature", 1.0)))

    def decode(self, enc, enc_lens, preserve_alignments: Optional[bool] = None
               ) -> List[List[int]]:
        """encoder output [B, T, D] + lengths -> token-id lists. The greedy
        strategies keep each token's emission frame in `last_alignments`
        with preserve_alignments (default: the config's); the beam
        strategies keep none."""
        self.last_alignments = None
        if self.strategy == "beam_batch":
            tokens, lens, _ = rnnt_beam_batched_decode(
                self.model, enc, enc_lens, beam_size=int(self._beam_cfg.get("beam_size", 4)),
                max_sym_exp=int(self._beam_cfg.get("tsd_max_sym_exp", 2) or 2),
                score_norm=bool(self._beam_cfg.get("score_norm", True)))
            tokens, lens = tokens.cpu().numpy(), lens.cpu().numpy()
            return [tokens[i, : lens[i]].tolist() for i in range(len(lens))]
        if self._beam is not None:
            # with return_best_hypothesis false, the first of the sorted n-best
            return [list((h[0] if isinstance(h, list) else h).y_sequence)
                    for h in self._beam(enc, enc_lens)]
        if preserve_alignments is None:
            preserve_alignments = self.preserve_alignments
        out = rnnt_greedy_decode_batched(self.model, enc, enc_lens, max_symbols=self.max_symbols,
                                         return_timestamps=preserve_alignments)
        tokens, lens = out[0].cpu().numpy(), out[1].cpu().numpy()
        if preserve_alignments:
            st = out[2].cpu().numpy()
            self.last_alignments = [st[i, : lens[i]].tolist() for i in range(len(lens))]
        return [tokens[i, : lens[i]].tolist() for i in range(len(lens))]

    def decode_to_text(self, enc, enc_lens) -> List[str]:
        return [self.tokenizer.ids_to_text(ids) for ids in self.decode(enc, enc_lens)]
