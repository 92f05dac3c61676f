"""RNN-T decoding facade (port of conformer_nemo_tpu/decode/rnnt_decoding.py):
the `decoding` config's strategy -> token ids -> text. greedy and
greedy_batch are ported (both run the batched greedy decoder, as in the JAX
package); the beam strategies wait for a later slice (ROADMAP.md)."""

from __future__ import annotations

from typing import List, Optional

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
        if self.strategy in BEAM:
            raise NotImplementedError(
                f"decoding strategy {self.strategy!r} is not ported yet (ROADMAP.md: the "
                "transducer beam strategies); use greedy or greedy_batch")
        if self.strategy not in GREEDY:
            raise ValueError(f"unknown decoding strategy {self.strategy!r}")
        greedy = cfg.get("greedy") or {}
        self.max_symbols = int(greedy.get("max_symbols", 10) or 10)
        self.preserve_alignments = bool(greedy.get("preserve_alignments", False))
        self.last_alignments = None

    def decode(self, enc, enc_lens, preserve_alignments: Optional[bool] = None
               ) -> List[List[int]]:
        """encoder output [B, T, D] + lengths -> token-id lists; with
        preserve_alignments (default: the config's) the emission frame of
        each token is kept in `last_alignments`."""
        if preserve_alignments is None:
            preserve_alignments = self.preserve_alignments
        out = rnnt_greedy_decode_batched(self.model, enc, enc_lens,
                                         max_symbols=self.max_symbols,
                                         return_timestamps=preserve_alignments)
        tokens, lens = out[0].cpu().numpy(), out[1].cpu().numpy()
        self.last_alignments = None
        if preserve_alignments:
            st = out[2].cpu().numpy()
            self.last_alignments = [st[i, : lens[i]].tolist() for i in range(len(lens))]
        return [tokens[i, : lens[i]].tolist() for i in range(len(lens))]

    def decode_to_text(self, enc, enc_lens) -> List[str]:
        return [self.tokenizer.ids_to_text(ids) for ids in self.decode(enc, enc_lens)]
