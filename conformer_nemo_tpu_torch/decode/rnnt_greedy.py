"""Batched greedy RNN-T decoding (port of
conformer_nemo_tpu/decode/rnnt_greedy.py).

For each frame t, an inner loop of at most `max_symbols` steps: one
prediction-network step and one joint step for the whole batch, argmax;
a sample whose argmax is blank (or whose length is exhausted) is done with
the frame and freezes its LSTM state and last label while the others go
on. The frame ends when every sample is done. Tokens go into a [B, cap]
buffer (cap = 2T unless given) that drops what overflows.

The JAX package runs this as one compiled program (a fori_loop over T with
a while_loop inside). Here the host drives the loop: each inner step needs
one device-to-host read (are all samples done?), so a model that rarely
emits blank (random weights) pays up to T * max_symbols small steps.
"""

from __future__ import annotations

from typing import Optional

import torch

from conformer_nemo_tpu_torch.models.conformer import _linear


@torch.no_grad()
def rnnt_greedy_decode_batched(model, enc: torch.Tensor, enc_lens: torch.Tensor, *,
                               max_symbols: int = 30, max_tokens: Optional[int] = None,
                               return_timestamps: bool = False):
    """model: an RNNTModel (eval mode); enc [B, T, D], enc_lens [B] ->
    (tokens [B, cap] int32 padded with blank, token_lens [B] int32), and
    with return_timestamps the emission frame of each token [B, cap]."""
    b, t_max, _ = enc.shape
    dev = enc.device
    blank = model.cfg.blank_id
    cap = max_tokens if max_tokens is not None else 2 * t_max
    joint, decoder = model.joint, model.decoder
    dt = joint.cfg.dtype
    e_all = _linear(joint.enc, enc, dt)  # the joint's encoder projection, row by row
    state = decoder.zero_state(b, dev)
    last = torch.full((b,), blank, dtype=torch.int64, device=dev)
    tokens = torch.full((b, cap), blank, dtype=torch.int32, device=dev)
    steps = torch.zeros((b, cap), dtype=torch.int32, device=dev)
    lens = torch.zeros((b,), dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev)
    enc_lens = enc_lens.to(dev)
    for t in range(t_max):
        f = e_all[:, t]
        done = t >= enc_lens
        for _ in range(max_symbols):
            if bool(done.all()):
                break
            g, new_state = decoder.step(last, state)
            logits = joint.combine(f + _linear(joint.pred, g, dt))
            k = logits.argmax(dim=-1)
            is_blank = k == blank
            advance = ~done & ~is_blank
            write = advance & (lens < cap)
            pos = lens.clamp(max=cap - 1)
            tokens[rows, pos] = torch.where(write, k.to(torch.int32), tokens[rows, pos])
            steps[rows, pos] = torch.where(write, torch.full_like(pos, t, dtype=torch.int32),
                                           steps[rows, pos])
            lens = torch.clamp(lens + advance.long(), max=cap)
            last = torch.where(advance, k, last)
            state = tuple(torch.where(advance[None, :, None], new, old)
                          for new, old in zip(new_state, state))
            done = done | is_blank
    lens = lens.to(torch.int32)
    if return_timestamps:
        return tokens, lens, steps
    return tokens, lens
