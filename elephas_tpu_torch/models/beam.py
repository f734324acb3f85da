"""Beam-search decoding for the TransformerLM family (port of
``elephas_tpu/models/beam.py``).

The ``beam_size`` axis is folded into the batch: ``B·K`` rows go through
the same cached :meth:`~TransformerLM.decode_step` every other decode path
uses (the flash-decode kernel on the card), one step per generated token.

- Scores are summed log-probs ``[B·K]``, ranked in float64 and returned
  in float32. The reference ranks in float32, where adding a beam's score
  can round two candidates the logits order into a tie; in float64 no
  such tie arises at these magnitudes, so ``beam_size=1`` is greedy
  ``generate`` exactly, as the reference's docstring promises.
- Each step ranks the ``K·V`` candidates of each sequence with one
  ``topk`` and moves the beams: their KV-cache rows (``index_select`` on
  the cache's batch axis, copied back in place), output buffers and flags
  go with them.
- A finished beam (``eos_id``) is frozen by giving it a single zero-cost
  continuation, the eos token itself.

The first step takes the top-K DISTINCT tokens of the prefill logits:
seeding K identical beams would make every later pick K copies of one
continuation. ``length_penalty`` α rescales the final scores by
``len^{-α}`` (len = generated tokens through each beam's eos); α = 0 ranks
by the raw joint log-prob.
"""

from __future__ import annotations

from typing import Optional

import torch

from .transformer import TransformerLM, _as_index


def generate_beam(model: TransformerLM, params, prompt, n_new: int,
                  beam_size: int = 4, eos_id: Optional[int] = None,
                  length_penalty: float = 0.0):
    """Beam-search continuation: ``prompt`` int ``[B, T0]`` → ``(sequences
    [B, T0 + n_new] int32, scores [B] float32)`` on the params' device.

    ``scores`` are the selected beams' summed next-token log-probs
    (length-normalised iff ``length_penalty > 0``). ``beam_size=1``
    reproduces greedy :meth:`TransformerLM.generate` exactly. With
    ``eos_id``, a beam that emits it is frozen: its later positions repeat
    ``eos_id`` and its score stops accumulating."""
    dev = params["tok"].device
    prompt = _as_index(prompt, dev)
    B, T0 = prompt.shape
    K = int(beam_size)
    if K < 1:
        raise ValueError(f"beam_size must be >= 1, got {K}")
    if K > model.vocab:
        raise ValueError(
            f"beam_size {K} exceeds vocab {model.vocab} (fewer than K "
            "distinct first tokens exist)")
    total = T0 + int(n_new)
    if total > model.max_len:
        raise ValueError(
            f"prompt {T0} + n_new {n_new} exceeds max_len {model.max_len}")
    if n_new < 1:
        return prompt.to(torch.int32), torch.zeros((B,), dtype=torch.float32,
                                                   device=dev)
    V = model.vocab
    with torch.no_grad():
        # prefill the B prompt rows once, then tile each row's cache to its
        # K beams (cheaper than prefilling B·K identical rows)
        logits, cache0 = model.prefill(params, prompt, model.init_cache(B, total))
        cache = {k: c.repeat_interleave(K, dim=1) for k, c in cache0.items()}
        del cache0
        logp0 = torch.log_softmax(logits[:, -1].to(torch.float64), dim=-1)
        top_lp, top_tok = torch.topk(logp0, K, dim=-1)               # [B, K]
        scores = top_lp.reshape(B * K)
        token = top_tok.reshape(B * K)
        buf = torch.zeros((B * K, total), dtype=torch.int64, device=dev)
        buf[:, :T0] = prompt.repeat_interleave(K, dim=0)
        buf[:, T0] = token
        finished = (token == eos_id if eos_id is not None
                    else torch.zeros((B * K,), dtype=torch.bool, device=dev))
        lengths = torch.ones((B * K,), dtype=torch.int32, device=dev)
        rows = torch.arange(B, device=dev)[:, None] * K               # [B, 1]
        if eos_id is not None:
            # frozen beams: exactly one candidate (eos again) at zero cost
            frozen = torch.full((V,), float("-inf"), dtype=torch.float64,
                                device=dev)
            frozen[int(eos_id)] = 0.0
        for t in range(T0, total - 1):
            logits, cache = model.decode_step(params, token, t, cache)
            lp = torch.log_softmax(logits.to(torch.float64), dim=-1)  # [B·K, V]
            if eos_id is not None:
                lp = torch.where(finished[:, None], frozen[None, :], lp)
            cand = (scores[:, None] + lp).reshape(B, K * V)
            new_scores, flat = torch.topk(cand, K, dim=-1)            # [B, K]
            parent = (rows + torch.div(flat, V, rounding_mode="floor")).reshape(-1)
            token = (flat % V).reshape(-1)
            # the beams move: their cache rows, buffers and flags go along
            for c in cache.values():
                c.copy_(c.index_select(1, parent))
            buf = buf.index_select(0, parent)
            buf[:, t + 1] = token
            finished = finished.index_select(0, parent)
            lengths = lengths.index_select(0, parent) + (~finished).to(torch.int32)
            if eos_id is not None:
                finished = finished | (token == eos_id)
            scores = new_scores.reshape(-1)
        ranked = scores
        if length_penalty:
            ranked = scores / lengths.to(torch.float64) ** float(length_penalty)
        best = ranked.reshape(B, K).argmax(dim=1)
        pick = torch.arange(B, device=dev) * K + best
    return (buf.index_select(0, pick).to(torch.int32),
            ranked.index_select(0, pick).to(torch.float32))
