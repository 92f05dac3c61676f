"""Batched RNN-T beam search on the device (strategy `beam_batch`; port of
conformer_nemo_tpu/decode/rnnt_beam_batched.py).

The whole batch decodes with K live hypotheses per sample, the beam
analogue of `greedy_batch`. Semantics follow time-synchronous decoding
(NeMo's BeamRNNTInfer tsd, Saon et al. 2020): at each encoder frame each
hypothesis makes up to `max_sym_exp` label expansions, and emitting blank
closes it for the frame. Prefix recombination is not done (a host-side
dict merge in the per-sample searches): it costs some search quality,
never the correctness of the best path kept.

Every shape is static: scores [B, K], tokens [B, K, cap] with
cap = min(2T, 512), the LSTM states [L, B, K, H]. Each expansion takes a
top-K over the K * blank label candidates (`torch.topk`, parents by
`torch.gather`), and the pool of closed hypotheses merges with a top-K of
the union. The loop over T x max_sym_exp issues device work only and
never reads back to the host.

Dead slots hold exactly -1e30 (a dead score plus any log-prob rounds back
to -1e30 in fp32), so ties among them are exact, and `torch.topk` orders
tied values otherwise than `lax.top_k`. A tie of dead slots cannot change
the best hypothesis this function returns: live scores are distinct from
-1e30 and sorted ahead of every dead slot by both, so the live slots hold
the same hypotheses in the same places, and the final argmax (scores
normalised by length or not) always picks a live slot. Only which dead
payload sits in which dead slot may differ.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from conformer_nemo_tpu_torch.models.conformer import _linear

NEG_INF = -1e30


@torch.no_grad()
def rnnt_beam_batched_decode(model, enc: torch.Tensor, enc_lens: torch.Tensor, *,
                             beam_size: int = 4, max_sym_exp: int = 2, score_norm: bool = True,
                             max_tokens: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """model: an RNNTModel (eval mode); enc [B, T, D], enc_lens [B] ->
    (tokens [B, cap] int32 padded with blank, token_lens [B] int32, the
    best hypothesis's score [B] fp32, normalised by its length with
    score_norm), all on enc's device."""
    b, t_max, _ = enc.shape
    dev = enc.device
    k = beam_size
    blank = model.cfg.blank_id
    cap = max_tokens if max_tokens is not None else min(2 * t_max, 512)
    joint, decoder = model.joint, model.decoder
    dt = joint.cfg.dtype
    n_layers, h_dim = decoder.cfg.pred_rnn_layers, decoder.cfg.pred_hidden
    e_all = _linear(joint.enc, enc, dt)  # the joint's encoder projection [B, T, Hj]
    enc_lens = enc_lens.to(dev)

    def pred_step(labels, h, c):
        """labels [B, K], states [L, B, K, H] -> (p [B, K, Hj], h, c)."""
        g, (nh, nc) = decoder.step(labels.reshape(b * k),
                                   (h.reshape(n_layers, b * k, h_dim),
                                    c.reshape(n_layers, b * k, h_dim)))
        return (_linear(joint.pred, g, dt).reshape(b, k, -1),
                nh.reshape(n_layers, b, k, h_dim), nc.reshape(n_layers, b, k, h_dim))

    def gather_k(x, idx):
        """x [B, N, ...] or [L, B, N, H]: the slots `idx` [B, K] along N."""
        if x.dim() == 4:  # [L, B, N, H]
            return torch.gather(x, 2, idx[None, :, :, None].expand(x.shape[0], b, k, x.shape[3]))
        if x.dim() == 3:
            return torch.gather(x, 1, idx[:, :, None].expand(b, k, x.shape[2]))
        return torch.gather(x, 1, idx)

    def merge(pool_a, pool_b):
        """The top-K of the union of two K-pools (scores first, then payload)."""
        top, idx = torch.topk(torch.cat([pool_a[0], pool_b[0]], dim=1), k, dim=1)
        return [top] + [gather_k(torch.cat([xa, xb], dim=2 if xa.dim() == 4 else 1), idx)
                        for xa, xb in zip(pool_a[1:], pool_b[1:])]

    # slot 0 holds the empty hypothesis, the others are dead
    scores = torch.full((b, k), NEG_INF, device=dev)
    scores[:, 0] = 0.0
    tokens = torch.full((b, k, cap), blank, dtype=torch.int32, device=dev)
    tlen = torch.zeros((b, k), dtype=torch.int32, device=dev)
    h = torch.zeros((n_layers, b, k, h_dim), device=dev)
    c = torch.zeros_like(h)
    # the start symbol's projection; its state is dropped, as the JAX package
    # drops it: a first label steps from the zero state
    p, _, _ = pred_step(torch.full((b, k), blank, dtype=torch.int64, device=dev), h, c)
    pos = torch.arange(cap, device=dev, dtype=torch.int32)
    neg = torch.tensor(NEG_INF, device=dev)

    for t in range(t_max):
        e_t = e_all[:, t, None, :]  # [B, 1, Hj]
        # the pool of hypotheses closed by a blank in this frame
        done = [torch.full((b, k), NEG_INF, device=dev), tokens, tlen, h, c, p]
        live = [scores, tokens, tlen, h, c, p]
        for step in range(max_sym_exp):
            logits = joint.combine(e_t + live[5])
            logp = torch.log_softmax(logits.float(), dim=-1)  # [B, K, V+1]
            done = merge(done, [live[0] + logp[:, :, blank], *live[1:]])
            if step == max_sym_exp - 1:
                break
            # label expansions: top-K over the K * blank label candidates
            lab = live[0][:, :, None] + logp[:, :, :blank]
            lab = torch.where((live[2] >= cap)[:, :, None], neg, lab)  # full hypotheses stop
            top, idx = torch.topk(lab.reshape(b, k * blank), k, dim=1)
            parent, label = idx // blank, idx % blank
            p_tokens, p_tlen = gather_k(live[1], parent), gather_k(live[2], parent)
            n_tokens = torch.where(pos == p_tlen[:, :, None], label[:, :, None].to(torch.int32),
                                   p_tokens)
            n_p, n_h, n_c = pred_step(label, gather_k(live[3], parent), gather_k(live[4], parent))
            live = [top, n_tokens, torch.clamp(p_tlen + 1, max=cap), n_h, n_c, n_p]
        # past its length a sample's frame changes nothing
        active = (t < enc_lens)[:, None]  # [B, 1]
        scores = torch.where(active, done[0], scores)
        tokens = torch.where(active[:, :, None], done[1], tokens)
        tlen = torch.where(active, done[2], tlen)
        h = torch.where(active[None, :, :, None], done[3], h)
        c = torch.where(active[None, :, :, None], done[4], c)
        p = torch.where(active[:, :, None], done[5], p)

    final = scores / torch.clamp(tlen.float(), min=1.0) if score_norm else scores
    best = torch.argmax(final, dim=1)  # the first of equal maxima, as jnp.argmax
    best_score = torch.gather(final, 1, best[:, None])[:, 0]
    best_tokens = torch.gather(tokens, 1, best[:, None, None].expand(b, 1, cap))[:, 0]
    best_len = torch.gather(tlen, 1, best[:, None])[:, 0]
    return best_tokens, best_len, best_score
